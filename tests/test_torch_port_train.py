"""The port's training step against the JAX package's, on the CPU in fp32.

- The tiny denoiser's loss and its whole gradient tree: the JAX side is a copy of
  ``make_loss_fn``'s composition (shared encoders, bootstrap without ``partial_pcd``,
  epsilon-MSE plus the gated chamfer) with dropout and CFG dropout off (encoders
  deterministic, ``cond_drop_prob=0``); t, noise and the coin are drawn from one key in
  ``make_loss_fn``'s split order and handed to the port; the port's gradients go through
  ``flax_from_params`` and are compared leaf by leaf.
- One AdamW step, the cosine and warmup-cosine schedules and an EMA update against optax
  and ``pcdiff.train.ema`` on the same gradients.
- The port's own dropout and CFG-dropout masks (masks cannot be matched across
  frameworks): rate, the 1 / (1 - p) scaling, full-batch against per-modality semantics.
- The device default: without a card, the entry points raise instead of building on the
  CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from pcdiff.diffusion import diffusion_from_betas as jdiffusion
from pcdiff.models import attention as jattn
from pcdiff.models.two_stream import TwoStreamDenoiser as JTwoStream
from pcdiff.train import ema as jema
from pcdiff.train import state as jstate
from pcdiff_torch.core import flax_from_params, init_params, params_from_flax
from pcdiff_torch.data import synthetic_batch
from pcdiff_torch.diffusion import diffusion_from_betas
from pcdiff_torch.models import attention as tattn
from pcdiff_torch.models.two_stream import TwoStreamDenoiser as TTwoStream
from pcdiff_torch.train import (
    create_train_state,
    ema_update,
    init_ema,
    make_loss_fn,
    make_train_step,
)
from pcdiff_torch.train import state as tstate

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores

TINY = dict(num_points=32, num_latents=8, latent_dim=32, x_dim=32, num_blocks=2,
            num_compute_layers=1, num_heads=4, num_classes=10, num_tokens_ppcd=4,
            num_tokens_depth=4, depth_image_size=32, depth_patch=16)
B = 2


@pytest.fixture(autouse=True)
def _fused_graph():
    jattn.set_ln_dense_fusion("on")
    yield
    jattn.set_ln_dense_fusion("auto")


def _params(jmod, rng, *args):
    """A random parameter tree of ``jmod``'s shapes (traced, not run), every path live."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), *args)["params"]
    flat = {}
    for path, sd in traverse_util.flatten_dict(shapes).items():
        z = rng.standard_normal(sd.shape).astype(np.float32)
        if path[-1] == "kernel":
            flat[path] = z / np.sqrt(np.prod(sd.shape[:-1]))
        elif path[-1] == "scale":
            flat[path] = 1.0 + 0.1 * z
        elif path[-1] == "bias":
            flat[path] = 0.1 * z
        else:
            flat[path] = 0.3 * z
    return traverse_util.unflatten_dict(flat)


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(3)
    batch = synthetic_batch(rng, B, 32, 4, 32)
    jmod = JTwoStream(**TINY, cond_drop_prob=0.0)
    params = _params(jmod, rng, batch["target"], np.zeros(B, np.int32),
                     batch["class_labels"], batch["viewpoints"], batch["partial_pcd"],
                     batch["depth_maps"])
    tmod = TTwoStream(**TINY, cond_drop_prob=0.0, device="cpu")
    tmod.load_state_dict(params_from_flax(params), strict=True)
    return jmod, params, tmod, batch


_COND = ("class_labels", "viewpoints", "partial_pcd", "depth_maps")


def _jax_loss(jmod, diff, use_sc):
    """make_loss_fn's composition with the draws as arguments, dropout off."""

    def loss(params, batch, t, noise, use_cd):
        p = {"params": params}
        target = batch["target"]
        x_t = diff.q_sample(target, t, noise=noise)
        raw = jmod.apply(p, B, train=False, method="encode_modalities",
                         **{k: batch[k] for k in _COND})
        boot_raw = dict(raw, partial_pcd=None)
        if use_sc:
            cond_b = jmod.apply(p, boot_raw, B, train=True, method="assemble_conditioning")
            _, latent = jmod.apply(p, x_t, t, train=True, cond_tokens=cond_b)
            prev = jax.lax.stop_gradient(latent)
        else:
            prev = jnp.zeros((B, jmod.latent_tokens, jmod.latent_dim), jnp.float32)

        def model_fn(x, tt):
            cond_m = jmod.apply(p, raw, B, train=True, method="assemble_conditioning")
            return jmod.apply(p, x, tt, train=True, cond_tokens=cond_m, prev_latent=prev)

        terms = diff.training_losses(model_fn, target, t, noise=noise, use_cd_xyz_loss=use_cd)
        return terms["loss"].mean(), {k: v.mean() for k, v in terms.items()}

    return loss


@pytest.mark.parametrize("sc_prob", [1.0, 0.0])  # the coin, both ways
def test_tiny_loss_and_gradients_match_jax(tiny, sc_prob):
    jmod, params, tmod, batch = tiny
    diff = jdiffusion("linear", 1000)
    key = jax.random.PRNGKey(7)
    k_t, k_noise, k_sc = jax.random.split(key, 8)[:3]  # make_loss_fn's split order
    t = jax.random.randint(k_t, (B,), 0, diff.num_timesteps)
    noise = jax.random.normal(k_noise, batch["target"].shape)
    use_sc = bool(jax.random.uniform(k_sc, ()) < sc_prob)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grad_fn = jax.jit(jax.value_and_grad(_jax_loss(jmod, diff, use_sc), has_aux=True))
    (want_loss, want_terms), want_grads = grad_fn(params, jbatch, t, noise, jnp.asarray(True))

    loss_fn = make_loss_fn(tmod, diffusion_from_betas("linear", 1000))
    tmod.train()
    for m in tmod.active_modalities:  # encoders deterministic, as on the JAX side
        getattr(tmod, f"encoders_{m}").eval()
    tmod.zero_grad(set_to_none=True)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with tattn.dropout_generator(torch.Generator().manual_seed(0)):
        loss, terms = loss_fn(tbatch, torch.from_numpy(np.array(t)).long(),
                              torch.from_numpy(np.array(noise)), use_sc, True)
    loss.backward()
    tmod.eval()
    assert terms["self_conditioned"] == float(use_sc)
    # fp32 on both sides through ~40 fused layers, the chamfer minima and the bootstrap;
    # only summation orders and the LN backward's form (kernel formula vs autodiff) differ
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for k in ("mse", "c_dist"):
        np.testing.assert_allclose(terms[k].item(), float(want_terms[k]), rtol=1e-5)
    got = traverse_util.flatten_dict(flax_from_params(
        tmod, {n: p.grad for n, p in tmod.named_parameters()}))
    want = traverse_util.flatten_dict(jax.device_get(want_grads))
    assert set(got) == set(want)
    scale = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        np.testing.assert_allclose(got[path], w, rtol=2e-4, atol=2e-5 * scale,
                                   err_msg="/".join(path))


def test_schedules_match_optax():
    for want, got in [
        (jstate.cosine_annealing_schedule(3e-4, 100, 1e-6),
         tstate.cosine_annealing_schedule(3e-4, 100, 1e-6)),
        (jstate.warmup_cosine_schedule(3e-4, 100), tstate.warmup_cosine_schedule(3e-4, 100)),
    ]:
        steps = np.array([0, 1, 2, 3, 4, 5, 6, 17, 50, 99, 100, 130])
        # optax evaluates in fp32, the port in float64: a few fp32 ulps of the peak apart
        np.testing.assert_allclose([got(int(s)) for s in steps],
                                   np.asarray(jax.vmap(want)(steps)), rtol=1e-6, atol=1e-10)
    assert tstate.warmup_cosine_schedule(3e-4, 100)(0) == 0.0


@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_adamw_steps_and_ema_match_optax(grad_clip):
    """Three updates of create_train_state's AdamW (cosine lr, optional global-norm clip)
    and an EMA update against optax.adamw and pcdiff.train.ema on the same gradients."""
    rng = np.random.default_rng(5)
    model = tattn.DecoderLayer(32, 4)  # 26 parameter tensors of every kind AdamW sees
    for p in model.parameters():
        p.data = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
    tree = flax_from_params(model)
    tx = optax.chain(*([optax.clip_by_global_norm(grad_clip)] if grad_clip else []),
                     optax.adamw(jstate.cosine_annealing_schedule(1e-2, 10), b1=0.9, b2=0.95,
                                 weight_decay=0.01))
    opt_state = tx.init(tree)
    update, apply = jax.jit(tx.update), jax.jit(optax.apply_updates)
    ema_step = jax.jit(jema.ema_update, static_argnums=2)
    state = create_train_state(model, lr=1e-2, total_steps=10, grad_clip=grad_clip,
                               device="cpu")
    ema, jema_tree = init_ema(model), jema.init_ema(tree)
    for _ in range(3):
        grads = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32) * 0.1)
                 for n, p in model.named_parameters()}
        updates, opt_state = update(flax_from_params(model, grads), opt_state, tree)
        tree = apply(tree, updates)
        for n, p in model.named_parameters():
            p.grad = grads[n].clone()
        state.apply_gradients()
        ema_update(ema, model, decay=0.9)
        jema_tree = ema_step(jema_tree, tree, 0.9)
    assert state.step == 3
    # the same update rule in fp32; torch and optax order the bias corrections and the
    # eps differently, a few ulp of each parameter
    for name, got in [("params", flax_from_params(model)),
                      ("ema", flax_from_params(model, ema))]:
        want = jema_tree if name == "ema" else tree
        flat_w = traverse_util.flatten_dict(jax.device_get(want))
        for path, g in traverse_util.flatten_dict(got).items():
            np.testing.assert_allclose(g, flat_w[path], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} {'/'.join(path)}")


def test_ema_update_equals_the_per_tensor_formula():
    """The multi-tensor EMA update is decay * ema + (1 - decay) * p of each tensor, with the
    same roundings as that formula taken one tensor at a time, bit for bit."""
    rng = np.random.default_rng(9)
    model = tattn.DecoderLayer(32, 4)
    for p in model.parameters():
        p.data = torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
    ema = init_ema(model)
    ref = {n: t.clone() for n, t in ema.items()}
    for decay in (0.9, 0.999, 0.9999):
        for p in model.parameters():
            p.data += torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
        ema_update(ema, model, decay)
        for n, p in model.named_parameters():
            ref[n] = ref[n] * decay + p * (1.0 - decay)
    assert all(torch.equal(ema[n], ref[n]) for n in ref)
    assert all(ema[n].data_ptr() != p.data_ptr() for n, p in model.named_parameters())


def test_dropout_rate_scaling_and_generator():
    x = torch.rand(200_000) + 0.5
    with tattn.dropout_generator(torch.Generator().manual_seed(0)):
        y = tattn.dropout(x, 0.1, True)
    dropped = (y == 0).float().mean().item()
    assert abs(dropped - 0.1) < 0.005  # ~7 standard deviations of the rate
    kept = y != 0
    assert torch.equal(y[kept], x[kept] / 0.9)  # flax's 1 / keep_prob scaling
    assert torch.equal(tattn.dropout(x, 0.1, False), x)  # eval: the identity
    with pytest.raises(RuntimeError, match="explicit generator"):
        tattn.dropout(x, 0.1, True)
    # the same generator state gives the same masks; train and eval modes differ
    layer = init_params(tattn.EncoderLayer(32, 4), torch.Generator().manual_seed(2)).train()
    h = torch.randn(2, 5, 32)
    outs = []
    for _ in range(2):
        with tattn.dropout_generator(torch.Generator().manual_seed(3)):
            outs.append(layer(h))
    assert torch.equal(outs[0], outs[1])
    assert not torch.allclose(outs[0], layer.eval()(h))


def test_cfg_dropout_masks():
    """Train-mode conditioning: type embeddings unmasked; a full-batch drop zeroes every
    modality of a row, per-modality keeps zero one; eval mode presence-masks."""
    model = init_params(TTwoStream(**TINY, device="cpu"), torch.Generator().manual_seed(2))
    counts = model.modality_token_counts()
    n = 4000
    raw = {m: (torch.ones(n, c, 32), torch.ones(n, 1, 1)) for m, c in counts.items()}
    raw["view"] = None  # an absent modality
    p = 0.3
    model.cond_drop_prob = p
    model.train()
    with tattn.dropout_generator(torch.Generator().manual_seed(1)):
        cond = model.assemble_conditioning(raw, n)
    bounds = np.cumsum([0] + list(counts.values()))
    live = torch.stack([cond[:, a:b].abs().amax(dim=(1, 2)) > 0
                        for a, b in zip(bounds[:-1], bounds[1:])], dim=1)
    # each chunk is either all there (tokens + type embedding, the absent view's type
    # embedding too) or all zero
    type_emb = model.token_type_embeddings.weight
    view = cond[:, 1]
    assert torch.all((view == 0).all(dim=1) | torch.isclose(view, type_emb[1]).all(dim=1))
    keep_rate = live.float().mean(dim=0)
    want_keep = (1 - p) * (1 - p)  # no full-batch drop and kept
    assert torch.all((keep_rate - want_keep).abs() < 0.03), keep_rate
    all_off = (~live).all(dim=1).float().mean().item()
    assert abs(all_off - (p + (1 - p) * p ** 4)) < 0.03, all_off
    # eval: tokens + type embedding * presence; the absent view stays zero
    model.eval()
    cond = model.assemble_conditioning(raw, n)
    assert torch.count_nonzero(cond[:, 1]) == 0
    assert torch.allclose(cond[:, 0], 1 + type_emb[0])


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TTwoStream(**TINY)
    model = TTwoStream(**TINY, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(model, diffusion_from_betas())


def test_train_step_runs_and_draws_from_its_generator():
    """Two runs of make_train_step from the same seeds give the same update; dropout and
    CFG dropout are on (train mode), the parameters move."""
    results = []
    for _ in range(2):
        torch.manual_seed(0)
        model = TTwoStream(**TINY, device="cpu")
        for p in model.parameters():
            p.data = 0.1 * torch.randn(p.shape)
        before = [p.detach().clone() for p in model.parameters()]
        state = create_train_state(model, lr=1e-3, total_steps=10, device="cpu")
        step = make_train_step(model, diffusion_from_betas(), self_conditioning_prob=1.0,
                               device="cpu")
        batch = synthetic_batch(np.random.default_rng(0), B, 32, 4, 32)
        metrics = step(state, batch, torch.Generator().manual_seed(4), True)
        assert model.training and metrics["self_conditioned"] == 1.0
        assert all(torch.isfinite(metrics[k]) for k in ("loss", "mse", "c_dist", "grad_norm"))
        moved = sum(not torch.equal(a, p) for a, p in zip(before, model.parameters()))
        assert moved == len(before)
        results.append([p.detach().clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*results))
