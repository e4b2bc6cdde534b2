"""``params_from_flax``: the JAX package's parameter trees as the port's ``state_dict``.

The flax tree is traced with ``jax.eval_shape`` (no init run) and filled from numpy.
"""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from pcdiff.models.rin import stack_rcw_block_params
from pcdiff.models.two_stream import TwoStreamDenoiser as JTwoStream
from pcdiff_torch.core import init_params, params_from_flax
from pcdiff_torch.models.two_stream import TwoStreamDenoiser as TTwoStream

torch.set_num_threads(2)

TINY = dict(num_points=16, num_latents=4, latent_dim=32, x_dim=32, num_blocks=3,
            num_compute_layers=2, num_heads=4, num_classes=10, num_tokens_ppcd=4,
            num_tokens_depth=4, depth_image_size=32, depth_patch=16)


def _tree(rng, **cfg):
    b = 1
    args = (np.zeros((b, 16, 3), np.float32), np.zeros(b, np.int32),
            np.zeros(b, np.int32), np.zeros((b, 3), np.float32),
            np.zeros((b, 4, 3), np.float32), np.zeros((b, 32, 32, 1), np.float32))
    shapes = jax.eval_shape(JTwoStream(**TINY, **cfg).init, jax.random.PRNGKey(0), *args)
    flat = {p: rng.standard_normal(sd.shape).astype(np.float32)
            for p, sd in traverse_util.flatten_dict(shapes["params"]).items()}
    return traverse_util.unflatten_dict(flat)


@pytest.fixture(scope="module")
def unrolled():
    return _tree(np.random.default_rng(0))


def test_unrolled_tree_loads_strict(unrolled):
    model = TTwoStream(**TINY, device="cpu")
    state = params_from_flax({"params": unrolled})
    model.load_state_dict(state, strict=True)
    sd = model.state_dict()
    assert set(sd) == set(state)
    rng_proj = unrolled["backbone"]["block_1"]["read"]["attn"]["wq"]["kernel"]
    assert torch.equal(sd["backbone.block_1.read.attn.wq.weight"],
                       torch.from_numpy(rng_proj.T.copy()))  # [in, out] -> [out, in]
    conv = unrolled["encoders_depth"]["patch_proj"]["kernel"]  # HWIO
    assert torch.equal(sd["encoders_depth.patch_proj.weight"],
                       torch.from_numpy(conv.transpose(3, 2, 0, 1).copy()))  # OIHW
    assert torch.equal(sd["backbone.ln_latent.weight"],
                       torch.from_numpy(unrolled["backbone"]["ln_latent"]["scale"]))
    assert torch.equal(sd["token_type_embeddings.weight"],
                       torch.from_numpy(unrolled["token_type_embeddings"]["embedding"]))


def test_stacked_layout_gives_the_same_port(unrolled):
    stacked = stack_rcw_block_params(unrolled)
    assert "blocks" in stacked["backbone"] and "block_0" not in stacked["backbone"]
    a, b = params_from_flax(unrolled), params_from_flax(stacked)
    assert set(a) == set(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_scan_blocks_tree_loads_strict():
    """The layout ``scan_blocks=True`` models produce (the bench default)."""
    tree = _tree(np.random.default_rng(1), scan_blocks=True)
    assert tree["backbone"]["blocks"]["block"]["read"]["attn"]["wq"]["kernel"].shape[0] == 3
    TTwoStream(**TINY, device="cpu").load_state_dict(params_from_flax(tree), strict=True)


def test_init_params_is_seeded():
    a, b = TTwoStream(**TINY, device="cpu"), TTwoStream(**TINY, device="cpu")
    init_params(a, torch.Generator().manual_seed(5))
    init_params(b, torch.Generator().manual_seed(5))
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert torch.count_nonzero(sa["backbone.ln_latent.weight"]) == 0  # zero-init
    assert torch.all(sa["backbone.ln_pre.weight"] == 1)
    assert all(torch.isfinite(v).all() for v in sa.values())
