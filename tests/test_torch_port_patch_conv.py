"""The depth encoder's patch projection without a convolution (CPU).

``PatchConv`` (kernel = stride = patch) is a reshape into patches and one matmul, so no path
of the port runs a cuDNN convolution, whose fp32 default on the card is TF32. It is held to
``F.conv2d`` (fp64 exactly, fp32 within summation order, bf16 within one rounding of the
output) and, inside the port's ``DepthMapEncoder``, to the JAX package's encoder (flax
``nn.Conv`` and the fused pre-LN graph the TPU runs) at 1e-5, with parameters and inputs from
numpy with a seed.
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import traverse_util

from pcdiff.models import attention as jattn
from pcdiff.models.encoders import DepthMapEncoder as JDepth
from pcdiff_torch.core import params_from_flax
from pcdiff_torch.models.encoders import DepthMapEncoder as TDepth
from pcdiff_torch.models.encoders import PatchConv

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores


def _conv(x, pc, rounding=None):
    """The stride-``patch`` convolution of NHWC ``x``; ``rounding``: the dtype the weights
    are rounded to first (the model dtype's), computed in x's dtype."""
    w, b = pc.weight, pc.bias
    if rounding is not None:
        w, b = w.to(rounding), b.to(rounding)
    return F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype), b.to(x.dtype),
                    stride=pc.patch).permute(0, 2, 3, 1)


@pytest.mark.parametrize("cin,patch,hw", [(1, 16, (32, 48)), (3, 4, (8, 12)), (2, 8, (8, 8))])
def test_patch_conv_is_the_convolution(rng, cin, patch, hw):
    pc = PatchConv(cin, 24, patch, dtype=torch.float64)
    with torch.no_grad():
        pc.weight.copy_(torch.from_numpy(rng.standard_normal(pc.weight.shape)))
        pc.bias.copy_(torch.from_numpy(rng.standard_normal(24)))
    x = torch.from_numpy(rng.random((2, *hw, cin)))
    got = pc(x)
    assert got.shape == (2, hw[0] // patch, hw[1] // patch, 24)
    # fp64: the same products, summed in another order
    torch.testing.assert_close(got, _conv(x, pc), rtol=1e-12, atol=1e-12)
    pc.float()
    pc.dtype = torch.float32
    torch.testing.assert_close(pc(x.float()), _conv(x.float(), pc), rtol=1e-5, atol=1e-5)


def test_patch_conv_bf16_rounds_like_the_model_dtype(rng):
    pc = PatchConv(1, 16, 8, dtype=torch.bfloat16)
    with torch.no_grad():
        pc.weight.copy_(torch.from_numpy(rng.standard_normal(pc.weight.shape) / 8))
        pc.bias.zero_()
    x = torch.from_numpy(rng.random((2, 16, 16, 1)).astype(np.float32))
    got = pc(x)
    assert got.dtype == torch.bfloat16
    ref = _conv(x.bfloat16().float(), pc, torch.bfloat16)  # bf16 operands, fp32 sums
    # one bf16 rounding of the output (2^-8 relative) and of the fp32 sum's order
    torch.testing.assert_close(got.float(), ref, rtol=2 ** -7, atol=1e-3)


def test_patch_conv_refuses_a_ragged_image():
    with pytest.raises(ValueError, match="not a multiple of the patch"):
        PatchConv(1, 8, 16)(torch.zeros(1, 40, 32, 1))


def test_depth_encoder_matches_jax(rng):
    """The whole depth encoder (patch projection, sin-cos position embedding, mixer and
    query decoder) against the JAX module, fp32, at 1e-5."""
    cfg = dict(embed_dim=32, num_tokens=4, patch=16, image_size=32, num_layers=2, num_heads=4)
    jmod = JDepth(**cfg)
    x = rng.random((2, 32, 32, 1)).astype(np.float32)
    jattn.set_ln_dense_fusion("on")
    try:
        shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x)["params"]
        flat = {}
        for path, sd in traverse_util.flatten_dict(shapes).items():
            z = rng.standard_normal(sd.shape).astype(np.float32)
            fan_in = np.prod(sd.shape[:-1]) if path[-1] == "kernel" else 1
            flat[path] = (z / np.sqrt(fan_in) if path[-1] == "kernel"
                          else 1.0 + 0.1 * z if path[-1] == "scale" else 0.1 * z)
        params = traverse_util.unflatten_dict(flat)
        want = np.asarray(jax.jit(jmod.apply)({"params": params}, x))
    finally:
        jattn.set_ln_dense_fusion("auto")
    tmod = TDepth(in_channels=1, **cfg, device="cpu").eval()
    tmod.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
