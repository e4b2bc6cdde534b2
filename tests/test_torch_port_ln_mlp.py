"""The port's whole-MLP kernel (K5) and the fully fused configuration against the JAX
package (CPU).

On the CPU the autograd wrapper :func:`pcdiff_torch.ops.ln_mlp.fused_ln_mlp` runs K5's
plain version, ``_torch_ln_mlp``, and the backward through the plain K3 and K4. Here:

- K5's plain version against the Pallas kernel it replaces, in interpret mode as
  ``tests/test_ln_mlp.py`` runs it, and against ``_xla_ln_mlp``; C, F and O are multiples
  of 128 (the JAX package's gate), N is ragged;
- the wrapper's gradient against JAX autodiff through ``fused_ln_mlp``'s custom VJP, and
  against finite differences (``gradcheck``, float64);
- the ``Mlp`` module, fused and on the dropout-active split path, against the JAX module
  under the same switches;
- the whole slice: the tiny ``TwoStreamDenoiser`` forward, and the tiny model's loss and
  gradient tree, in the fully fused configuration (``set_ln_mlp_fusion("on")`` and the
  LayerNorm kernel backend on both sides), with the same weights through
  ``params_from_flax``.

Inputs come from numpy with a seed and go to both packages; weights go to the port in the
``nn.Linear`` layout (transposed).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from jax.experimental.pallas import tpu as pltpu

from pcdiff.diffusion import diffusion_from_betas as jdiffusion
from pcdiff.models import attention as jattn
from pcdiff.models.two_stream import TwoStreamDenoiser as JTwoStream
from pcdiff.ops import layer_norm as jln
from pcdiff.ops import ln_dense as jld
from pcdiff_torch.core import flax_from_params, params_from_flax
from pcdiff_torch.diffusion import diffusion_from_betas
from pcdiff_torch.models import attention as tattn
from pcdiff_torch.models.two_stream import TwoStreamDenoiser as TTwoStream
from pcdiff_torch.ops import layer_norm as tln
from pcdiff_torch.ops import ln_dense as tld
from pcdiff_torch.ops import ln_mlp as tlm
from pcdiff_torch.train import make_loss_fn

from .test_torch_port_models import _params, _tiny_batch
from .test_torch_port_train import _jax_loss

torch.set_num_threads(2)

TINY = dict(num_points=32, num_latents=8, latent_dim=32, x_dim=32, num_blocks=2,
            num_compute_layers=1, num_heads=4, num_classes=10, num_tokens_ppcd=4,
            num_tokens_depth=4, depth_image_size=32, depth_patch=16)


@pytest.fixture
def fully_fused():
    """The fully fused configuration on both sides (the JAX graph of the TPU, with the
    pre-LN fused into every projection)."""
    jattn.set_ln_dense_fusion("on")
    jattn.set_ln_mlp_fusion("on")
    jln.set_layernorm_backend("pallas")
    tattn.set_ln_mlp_fusion("on")
    tln.set_layernorm_backend("kernel")
    yield
    jattn.set_ln_mlp_fusion("off")
    jattn.set_ln_dense_fusion("auto")
    jln.set_layernorm_backend("auto")
    tattn.set_ln_mlp_fusion("off")
    tln.set_layernorm_backend("auto")


def _mlp_inputs(rng, b, n, c, f, o):
    x = (rng.standard_normal((b, n, c)) * 2 + 0.5).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    w1 = (rng.standard_normal((c, f)) / np.sqrt(c)).astype(np.float32)
    b1 = (0.2 * rng.standard_normal(f)).astype(np.float32)
    w2 = (rng.standard_normal((f, o)) / np.sqrt(f)).astype(np.float32)
    b2 = (0.2 * rng.standard_normal(o)).astype(np.float32)
    return x, scale, bias, w1, b1, w2, b2


def _port_args(x, scale, bias, w1, b1, w2, b2):
    """The same arrays as torch tensors, weights in the nn.Linear layout."""
    t = [torch.from_numpy(np.ascontiguousarray(a)) for a in (x, scale, bias, w1.T, b1, w2.T, b2)]
    return t


@pytest.mark.parametrize("act", ["gelu", "gelu_tanh"])
def test_ln_mlp_fwd_matches_pallas_and_xla(rng, act):
    arrs = _mlp_inputs(rng, 2, 37, 128, 256, 128)
    jargs = [jnp.asarray(a) for a in arrs]
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(jld._pallas_ln_mlp(*jargs, 1e-5, jnp.float32, act))
    xla = np.asarray(jld._xla_ln_mlp(*jargs, 1e-5, jnp.float32, act))
    got = tlm._torch_ln_mlp(*_port_args(*arrs), 1e-5, torch.float32, act).numpy()
    # fp32 LN, products and activation on every side; only summation orders differ
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-5)


def test_ln_mlp_fwd_bf16_matches_pallas(rng):
    """The bf16 model's class: x, y, W1, W2 and h rounded to bf16, fp32 accumulation, one
    cast out."""
    arrs = _mlp_inputs(rng, 2, 37, 128, 256, 128)
    xb = jnp.asarray(arrs[0]).astype(jnp.bfloat16)
    jargs = [xb] + [jnp.asarray(a) for a in arrs[1:]]
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jld._pallas_ln_mlp(*jargs, 1e-5, jnp.bfloat16, "gelu_tanh"),
                          np.float32)
    targs = _port_args(*arrs)
    targs[0] = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = tlm._torch_ln_mlp(*targs, 1e-5, torch.bfloat16, "gelu_tanh").float().numpy()
    # a last-bit difference in an fp32 sum can flip one bf16 rounding of y or h (2^-8
    # relative), which moves an output by ~2^-8 of one product term; the output takes
    # one bf16 rounding (2^-8 of the element)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * np.abs(want).max())
    assert np.abs(got - want).mean() < 2e-3 * np.abs(want).mean()


def test_ln_mlp_autograd_matches_jax(rng):
    """The CPU wrapper's gradients == jax.grad through fused_ln_mlp's custom VJP
    (``_mlp_bwd`` over the XLA fc1 stage off the TPU), fp32."""
    arrs = _mlp_inputs(rng, 2, 37, 128, 256, 128)
    g = rng.standard_normal((2, 37, 128)).astype(np.float32)

    def f(*a):
        return jnp.sum(jld.fused_ln_mlp(*a, 1e-5, jnp.float32, "gelu") * g)

    want = jax.grad(f, argnums=tuple(range(7)))(*map(jnp.asarray, arrs))
    targs = [t.requires_grad_() for t in _port_args(*arrs)]
    (tlm.fused_ln_mlp(*targs, 1e-5, torch.float32, "gelu") * torch.from_numpy(g)).sum().backward()
    names = ("dx", "dscale", "dbias", "dw1", "db1", "dw2", "db2")
    for name, t, w in zip(names, targs, want):
        got = t.grad.numpy()
        if name in ("dw1", "dw2"):
            got = got.T  # back to the JAX package's [in, out] layout
        w = np.asarray(w)
        # fp32 on both sides; the LN backward is the kernel formula on both, the weight
        # gradients sum 74 rows in another order
        np.testing.assert_allclose(got, w, rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    assert tlm.launches == 0 and tld.launches == 0 and tld.bwd_launches == 0


def test_ln_mlp_dw2_stays_fp32_in_bf16(rng):
    """fc2's weight gradient accumulates in fp32 and stays fp32 in the bf16 model, as the
    JAX package keeps it (``preferred_element_type=float32``, then the weight's dtype)."""
    arrs = _mlp_inputs(rng, 2, 37, 128, 256, 128)
    targs = [t.requires_grad_() for t in _port_args(*arrs)]
    x = targs[0].detach().to(torch.bfloat16).requires_grad_()
    out = tlm.fused_ln_mlp(x, *targs[1:], 1e-5, torch.bfloat16, "gelu_tanh")
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    assert all(t.grad.dtype == torch.float32 for t in targs[1:])
    # dW2 = g^T a with g = 1: the column sums of a (bf16 products, fp32 sums)
    (a,) = tld._torch_ln_denses(x.detach(), targs[1].detach(), targs[2].detach(),
                                [targs[3].detach()], [targs[4].detach()], 1e-5,
                                torch.bfloat16, ["gelu_tanh"])
    want = a.float().reshape(-1, 256).sum(dim=0).expand(128, 256)
    torch.testing.assert_close(targs[5].grad, want, rtol=1e-6, atol=1e-4)


def test_ln_mlp_autograd_gradcheck():
    """The autograd wrapper (plain path) against finite differences, float64."""
    g = torch.Generator().manual_seed(1)
    f64 = dict(dtype=torch.float64, generator=g)
    x = (torch.randn(2, 3, 8, **f64) * 2 + 0.5).requires_grad_()
    scale = (1 + 0.2 * torch.randn(8, **f64)).requires_grad_()
    bias = (0.2 * torch.randn(8, **f64)).requires_grad_()
    w1 = (torch.randn(12, 8, **f64) / 3).requires_grad_()
    b1 = (0.2 * torch.randn(12, **f64)).requires_grad_()
    w2 = (torch.randn(6, 12, **f64) / 3).requires_grad_()
    b2 = (0.2 * torch.randn(6, **f64)).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda *a: tlm.fused_ln_mlp(*a, 1e-5, torch.float64, "gelu"),
        (x, scale, bias, w1, b1, w2, b2))


class _JMlp(fnn.Module):
    drop: float

    @fnn.compact
    def __call__(self, x, deterministic=True):
        ln = jattn._LNParams(name="ln")(x.shape[-1])
        return jattn.Mlp(128, drop=self.drop, name="mlp")(x, deterministic, ln=ln)


class _TMlp(torch.nn.Module):
    def __init__(self, drop):
        super().__init__()
        self.ln = tattn.LayerNorm(32)
        self.mlp = tattn.Mlp(32, 128, drop=drop)

    def forward(self, x):
        return self.mlp(x, ln=self.ln)


@pytest.mark.parametrize("drop", [0.0, 0.1])
def test_mlp_module_fused_matches_jax(rng, fully_fused, drop):
    """Eval mode (and rate 0) takes the whole-MLP path on both sides."""
    x = rng.standard_normal((2, 17, 32)).astype(np.float32)
    jmod = _JMlp(drop)
    params = _params(jmod, rng, x)
    want = jax.jit(jmod.apply)({"params": params}, x)
    tmod = _TMlp(drop)
    tmod.load_state_dict(params_from_flax(params), strict=True)
    np.testing.assert_allclose(tmod.eval()(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)


def test_mlp_module_dropout_takes_the_split_path(rng, fully_fused, monkeypatch):
    """Active dropout between fc1 and fc2 cannot cross the kernel: in train mode with a
    nonzero rate the module takes the split path, whose output (same masks) equals the
    split path's with the fusion off; at rate 0 train mode keeps the whole-MLP path."""
    x = torch.from_numpy(rng.standard_normal((2, 17, 32)).astype(np.float32))
    tmod = _TMlp(0.1)
    for p in tmod.parameters():
        p.data = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) * 0.3
    calls = []
    real = tattn.fused_ln_mlp
    monkeypatch.setattr(tattn, "fused_ln_mlp", lambda *a: calls.append(1) or real(*a))
    outs = []
    for mode in ("on", "off"):
        tattn.set_ln_mlp_fusion(mode)
        with tattn.dropout_generator(torch.Generator().manual_seed(3)):
            outs.append(tmod.train()(x))
    assert not calls
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    tattn.set_ln_mlp_fusion("on")
    tmod.mlp.drop = 0.0
    tmod.train()(x)
    assert calls


def test_ln_mlp_fusion_switch():
    assert not tattn.fuse_ln_mlp_enabled()  # off by default, as in the JAX package
    tattn.set_ln_mlp_fusion("auto")  # the port runs only the fused LN+Dense graph
    assert tattn.fuse_ln_mlp_enabled()
    tattn.set_ln_mlp_fusion("off")
    assert not tattn.fuse_ln_mlp_enabled()
    with pytest.raises(ValueError, match="unknown LN\\+MLP fusion mode"):
        tattn.set_ln_mlp_fusion("kernel")


@pytest.fixture(scope="module")
def tiny_fwd():
    rng = np.random.default_rng(11)
    batch = _tiny_batch(rng, 2)
    x, t = rng.standard_normal((2, 32, 3)).astype(np.float32), np.array([5, 640], np.int32)
    jmod = JTwoStream(**TINY)
    params = _params(jmod, rng, x, t, *batch.values())
    tmod = TTwoStream(**TINY, device="cpu")
    tmod.load_state_dict(params_from_flax(params), strict=True)
    prev = (0.5 * rng.standard_normal((2, tmod.latent_tokens, 32))).astype(np.float32)
    return jmod, params, tmod.eval(), batch, x, t, prev


def test_two_stream_denoiser_fully_fused(tiny_fwd, fully_fused):
    jmod, params, tmod, batch, x, t, prev = tiny_fwd
    fwd = jax.jit(lambda p, x, t, prev, kw: jmod.apply({"params": p}, x, t, prev_latent=prev,
                                                          **kw))
    want_eps, want_lat = fwd(params, x, t, prev, batch)
    with torch.no_grad():
        eps, lat = tmod(torch.from_numpy(x), torch.from_numpy(t),
                        prev_latent=torch.from_numpy(prev),
                        **{k: torch.from_numpy(v) for k, v in batch.items()})
    # fp32 on both sides through ~40 fused layers; only summation orders and the erf form
    # differ
    np.testing.assert_allclose(eps.numpy(), np.asarray(want_eps), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(lat.numpy(), np.asarray(want_lat), rtol=1e-4, atol=1e-4)


def test_tiny_loss_and_gradients_fully_fused(fully_fused):
    """The tiny model's loss and whole gradient tree, fully fused, against the JAX
    ``make_loss_fn`` composition of ``test_torch_port_train`` in the same configuration:
    the backbone's MLPs (dropout 0) take the whole-MLP path on both sides and its
    standalone LayerNorms the kernel backend; the encoders run deterministic."""
    from pcdiff_torch.data import synthetic_batch

    b = 2
    rng = np.random.default_rng(13)
    batch = synthetic_batch(rng, b, 32, 4, 32)
    jmod = JTwoStream(**TINY, cond_drop_prob=0.0)
    params = _params(jmod, rng, batch["target"], np.zeros(b, np.int32), batch["class_labels"],
                     batch["viewpoints"], batch["partial_pcd"], batch["depth_maps"])
    tmod = TTwoStream(**TINY, cond_drop_prob=0.0, device="cpu")
    tmod.load_state_dict(params_from_flax(params), strict=True)
    diff = jdiffusion("linear", 1000)
    t = np.array([17, 702], np.int32)
    noise = rng.standard_normal(batch["target"].shape).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grad_fn = jax.jit(jax.value_and_grad(_jax_loss(jmod, diff, True), has_aux=True))
    (want_loss, _), want_grads = grad_fn(params, jbatch, t, noise, jnp.asarray(True))

    tmod.train()
    for m in tmod.active_modalities:  # encoders deterministic, as on the JAX side
        getattr(tmod, f"encoders_{m}").eval()
    with tattn.dropout_generator(torch.Generator().manual_seed(0)):
        loss, _ = make_loss_fn(tmod, diffusion_from_betas("linear", 1000))(
            {k: torch.from_numpy(v) for k, v in batch.items()}, torch.from_numpy(t).long(),
            torch.from_numpy(noise), True, True)
    loss.backward()
    tmod.eval()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = traverse_util.flatten_dict(flax_from_params(
        tmod, {n: p.grad for n, p in tmod.named_parameters()}))
    want = traverse_util.flatten_dict(jax.device_get(want_grads))
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    # fp32 through ~40 fused layers, the chamfer minima and the bootstrap; summation
    # orders and the LN backward's form differ
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=2e-4, atol=2e-5 * scale,
                                   err_msg="/".join(path))
