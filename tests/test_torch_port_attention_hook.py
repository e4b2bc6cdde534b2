"""The head-split attention (K7's plain version and its autograd) and the ``attention_fn``
hook through the port's models, against the JAX package's (CPU).

- ``_torch_attention`` against the TPU kernel ``_pallas_attention`` in interpret mode, with
  ragged Nq and Nk (Nk not a multiple of 8: the TPU kernel pads and masks) and D = 32, 64.
- ``fused_attention``'s forward and backward against ``jax.vjp`` through
  ``pcdiff.ops.fused_attention`` (its XLA ``_bwd``), and ``gradcheck`` in fp64.
- The tiny denoiser with its three hooks set to ``fused_attention`` against the JAX model
  with its hooks set to ``pcdiff.ops.fused_attention``, on one parameter tree (the hooks do
  not change it): the forward, and one loss with its whole gradient tree. The hooked port
  model against the default one, and a spy on which branch each attention takes.
"""

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
from pcdiff.ops import flash_attention as jfa
from pcdiff_torch.core import flax_from_params, params_from_flax
from pcdiff_torch.data import synthetic_batch
from pcdiff_torch.diffusion import diffusion_from_betas
from pcdiff_torch.models import attention as tattn
from pcdiff_torch.models.two_stream import TwoStreamDenoiser as TTwoStream
from pcdiff_torch.ops import flash_attention as tfa
from pcdiff_torch.train import make_loss_fn

from .test_torch_port_train import _COND, B, TINY, _jax_loss, _params

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores

J_HOOKS = dict(read_attention_fn=jfa.fused_attention, write_attention_fn=jfa.fused_attention,
               compute_attention_fn=jfa.fused_attention)
T_HOOKS = dict(read_attention_fn=tfa.fused_attention, write_attention_fn=tfa.fused_attention,
               compute_attention_fn=tfa.fused_attention)
# The hooks reach the backbone only. The comparisons with JAX leave out the point-cloud and
# depth encoders, whose compile is most of the JAX program's; the spy keeps them.
HOOK_TINY = dict(TINY, active_modalities=("class", "view"))


@pytest.fixture(autouse=True)
def _fused_graph():
    jattn.set_ln_dense_fusion("on")
    yield
    jattn.set_ln_dense_fusion("auto")


def _split_qkv(rng, nq, nk, d, heads=3):
    q = rng.standard_normal((2, heads, nq, d)).astype(np.float32) * d ** -0.5 * 2
    k = rng.standard_normal((2, heads, nk, d)).astype(np.float32)
    v = rng.standard_normal((2, heads, nk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("nq,nk,d", [(37, 67, 32), (29, 131, 64)])
def test_split_attention_fp32_matches_pallas(rng, nq, nk, d):
    q, k, v = _split_qkv(rng, nq, nk, d)
    with pltpu.force_tpu_interpret_mode():
        want = jfa._pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tfa._torch_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    # fp32 scores, weights and PV on both sides; only the summation order differs
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nq,nk,d", [(37, 67, 32), (29, 131, 64)])
def test_split_attention_bf16_matches_pallas(rng, nq, nk, d):
    """K7's bf16 numerics: fp32 scores, weights normalised before they are rounded to
    bf16, fp32 PV, a bf16 output."""
    q, k, v = (a.astype(jnp.bfloat16) for a in _split_qkv(rng, nq, nk, d))
    with pltpu.force_tpu_interpret_mode():
        want = jfa._pallas_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = tfa._torch_attention(*(torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                                 for a in (q, k, v)))
    want = np.asarray(want, np.float32)
    # same roundings; a summation-order difference can flip one bf16 rounding of a weight
    # (2^-8 of that weight times |v| < 5) or of the output (one bf16 ulp, 2^-7 relative)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7, atol=2e-3)
    assert np.mean(got.float().numpy() != want) < 0.02


def test_split_attention_autograd_matches_jax(rng):
    q, k, v = _split_qkv(rng, 37, 67, 32)
    g = rng.standard_normal(q.shape).astype(np.float32)
    want, vjp = jax.vjp(jfa.fused_attention, *(jnp.asarray(a) for a in (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = tfa.fused_attention(tq, tk, tv)
    got.backward(torch.from_numpy(g))
    # fp32 on both sides (the JAX forward off the TPU is XLA, the backward its _bwd)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    for t, w in zip((tq, tk, tv), want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    assert tfa.k7_launches == 0  # no kernel on a CPU tensor


def test_split_attention_gradcheck():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, n, 8, generator=g, dtype=torch.float64, requires_grad=True)
               for n in (5, 7, 7))
    assert torch.autograd.gradcheck(tfa.fused_attention, (q, k, v))


def test_split_kernel_rejects_strided_rows():
    """The kernel takes batch, head and row strides; a row whose D elements are not
    contiguous is refused before anything is built or launched."""
    q, k, v = (torch.zeros(2, 3, n, 32) for n in (5, 7, 7))
    with pytest.raises(ValueError, match="unit stride"):
        tfa._launch_split(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    assert tfa.k7_launches == 0


def _tiny_inputs(rng):
    batch = synthetic_batch(rng, B, 32, 4, 32)
    x = rng.standard_normal((B, 32, 3)).astype(np.float32)
    t = np.array([3, 817], dtype=np.int32)
    return batch, x, t


def _tiny_models(config, routings):
    """The port's tiny denoiser in each routing, from one JAX parameter tree, and inputs."""
    rng = np.random.default_rng(5)
    batch, x, t = _tiny_inputs(rng)
    jmod = JTwoStream(**config, cond_drop_prob=0.0)
    params = _params(jmod, rng, x, t, *(batch[k] for k in _COND))
    state = params_from_flax(params)
    tmods = {}
    for name in routings:
        hooks = T_HOOKS if name == "hooked" else {}
        tmods[name] = TTwoStream(**config, cond_drop_prob=0.0, device="cpu", **hooks)
        tmods[name].load_state_dict(state, strict=True)
    prev = (0.5 * rng.standard_normal((B, tmods[routings[0]].latent_tokens, 32))).astype(np.float32)
    return params, tmods, batch, x, t, prev


@pytest.fixture(scope="module")
def tiny():
    """The port's tiny denoiser, default and hooked, at ``HOOK_TINY``."""
    return _tiny_models(HOOK_TINY, ("default", "hooked"))


@pytest.fixture(scope="module")
def jax_hooked(tiny):
    """The hooked JAX model's forward, and one self-conditioned loss with its gradient tree
    at the draws it returns, from one compiled program (one compile for both tests)."""
    params, _, batch, x, t, prev = tiny
    jhooked = JTwoStream(**HOOK_TINY, cond_drop_prob=0.0, **J_HOOKS)
    diff = jdiffusion("linear", 1000)
    k_t, k_noise = jax.random.split(jax.random.PRNGKey(11), 8)[:2]
    t_loss = jax.random.randint(k_t, (B,), 0, diff.num_timesteps)
    noise = jax.random.normal(k_noise, batch["target"].shape)
    loss_and_grad = jax.value_and_grad(_jax_loss(jhooked, diff, True), has_aux=True)

    def run(p, jbatch, x, t, prev):
        fwd = jhooked.apply({"params": p}, x, t, prev_latent=prev,
                            **{k: jbatch[k] for k in _COND})
        (loss, _), grads = loss_and_grad(p, jbatch, t_loss, noise, jnp.asarray(True))
        return fwd, loss, grads

    fwd, loss, grads = jax.jit(run)(params, {k: jnp.asarray(v) for k, v in batch.items()},
                                    x, t, prev)
    return {"forward": fwd, "loss": loss, "grads": jax.device_get(grads), "t": t_loss,
            "noise": noise}


def _port_forward(tmod, batch, x, t, prev):
    with torch.no_grad():
        return tmod(torch.from_numpy(x), torch.from_numpy(t), prev_latent=torch.from_numpy(prev),
                    **{k: torch.from_numpy(batch[k]) for k in _COND})


def test_hooked_denoiser_matches_jax(tiny, jax_hooked):
    _, tmods, batch, x, t, prev = tiny
    want = jax_hooked["forward"]
    got = _port_forward(tmods["hooked"], batch, x, t, prev)
    # fp32 on both sides through the denoiser's 30-odd layers, as the default model's test
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)


def test_hooked_denoiser_matches_default_routing(tiny):
    _, tmods, batch, x, t, prev = tiny
    hooked = _port_forward(tmods["hooked"], batch, x, t, prev)
    default = _port_forward(tmods["default"], batch, x, t, prev)
    # one function, one set of weights; the folded and the split heads sum in other orders
    for a, w in zip(hooked, default):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


def test_default_hook_keeps_heads_folded(monkeypatch):
    """The default ``dot_product_attention`` never reaches the head-split branch; a custom
    hook gets [B, H, N, D] heads at every backbone attention and nowhere else (the
    encoders of all four modalities keep K1)."""
    _, tmods, batch, x, t, prev = _tiny_models(TINY, ("default",))
    calls = {"mh": 0, "split": 0}
    mh = tattn.fused_attention_mh

    def count_mh(*args):
        calls["mh"] += 1
        return mh(*args)

    def count_split(*args):
        calls["split"] += 1
        return tfa.fused_attention(*args)

    monkeypatch.setattr(tattn, "fused_attention_mh", count_mh)
    monkeypatch.setattr(tattn, "fused_attention", count_split)
    default = _port_forward(tmods["default"], batch, x, t, prev)
    folded = calls["mh"]
    assert calls["split"] == 0 and folded > 0

    shapes = []

    def spy(q, k, v):
        shapes.append((q.shape, k.shape, v.shape))
        return tfa.fused_attention(q, k, v)

    spied = TTwoStream(**TINY, cond_drop_prob=0.0, device="cpu", read_attention_fn=spy,
                       write_attention_fn=spy, compute_attention_fn=spy)
    spied.load_state_dict(tmods["default"].state_dict())
    calls["mh"] = 0
    out = _port_forward(spied, batch, x, t, prev)
    backbone = TINY["num_blocks"] * (TINY["num_compute_layers"] + 2)
    assert len(shapes) == backbone and calls["mh"] == folded - backbone
    heads, d = TINY["num_heads"], TINY["latent_dim"] // TINY["num_heads"]
    n_x, n_z = TINY["num_points"], tmods["default"].latent_tokens
    assert shapes[0] == ((B, heads, n_z, d), (B, heads, n_x, d), (B, heads, n_x, d))  # read
    assert shapes[-1] == ((B, heads, n_x, d), (B, heads, n_z, d), (B, heads, n_z, d))  # write
    for a, w in zip(out, default):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)


def test_hooked_loss_and_gradients_match_jax(tiny, jax_hooked):
    """One self-conditioned loss and its whole gradient tree through the hooked models (the
    JAX side's hooks backpropagate through their XLA ``_bwd``, the port's through its copy)."""
    _, tmods, batch, _, _, _ = tiny
    tmod = tmods["hooked"]
    t, noise = jax_hooked["t"], jax_hooked["noise"]

    loss_fn = make_loss_fn(tmod, diffusion_from_betas("linear", 1000))
    tmod.train()
    for m in tmod.active_modalities:  # encoders deterministic, as on the JAX side
        getattr(tmod, f"encoders_{m}").eval()
    tmod.zero_grad(set_to_none=True)
    with tattn.dropout_generator(torch.Generator().manual_seed(0)):
        loss, _ = loss_fn({k: torch.from_numpy(v) for k, v in batch.items()},
                          torch.from_numpy(np.array(t)).long(),
                          torch.from_numpy(np.array(noise)), True, True)
    loss.backward()
    tmod.eval()
    # the tolerances of test_torch_port_train.py's default-routing gradient tree
    np.testing.assert_allclose(loss.item(), float(jax_hooked["loss"]), rtol=1e-5)
    got = traverse_util.flatten_dict(flax_from_params(
        tmod, {n: p.grad for n, p in tmod.named_parameters()}))
    want = traverse_util.flatten_dict(jax_hooked["grads"])
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=2e-4, atol=2e-5 * scale,
                                   err_msg="/".join(path))
