"""The port's multi-rank sampling paths on gloo ranks on the CPU, against the JAX package on
conftest's 8 virtual devices and against one process: x-stream sequence parallelism
(``pcdiff_torch/parallel/xsp.py``), the Picard window sharded over ranks, the P-FID
extractor's rows sharded over ranks, and the multi-rank dryrun.

Two rank groups: two ranks (a ``FileStore`` in ``tmp_path``) run every check of the
primitives, the backbone, the window and the extractor in one spawn; the dryrun's CPU run
spawns four. The JAX side and the one-process references run here, on the same inputs
(made from seeds with numpy) and the same weights (the port's seeded ones, carried to the
JAX side). Tolerances: the primitives rtol 1e-5 (``tests/test_xsp.py``'s), the
backbone against the JAX dense one rtol 1e-4, atol 1e-5 (``tests/test_sharded_backbone.py``'s),
its gradients against one process's rel 1e-5, the window-sharded ``heun_parallel`` equal
Picard rounds and rtol 1e-5 (``tests/test_parallel_sampler.py:105-120``), the extractor
rtol 1e-5 (``tests/test_evals.py:356``'s).
"""

import functools

import numpy as np
import pytest
import torch

from pcdiff_torch.core import flax_from_params, init_params
from pcdiff_torch.diffusion.parallel import sample_heun_parallel
from pcdiff_torch.evals.feature_extractor import PointNetClassifier
from pcdiff_torch.models import TwoStreamDenoiser
from pcdiff_torch.models.rin import DenoiserBackbone
from pcdiff_torch.parallel import xsp
from pcdiff_torch.parallel.mesh import MODEL_AXIS, sum_partials
from pcdiff_torch.scripts import multichip_dryrun as md

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores

WORLD = 2
B, H, D = 2, 4, 16  # the primitives' (tests/test_xsp.py's)
BB, NUM_X, NUM_Z, DIM, N_COND = 2, 64, 8, 32, 6  # the backbone's (test_sharded_backbone.py's)
TB, TN, TC, STEPS = 4, 16, 3, 12  # the toy solve's (test_parallel_sampler.py's)
CLOUDS, CLOUD_POINTS, CHUNK = 10, 64, 8  # the extractor's (test_evals.py:356's)


def _backbone_kwargs():
    return dict(num_x=NUM_X, num_z=NUM_Z, z_dim=DIM, x_dim=DIM, num_blocks=2,
                num_compute_layers=1, num_heads=4)


def _toy(x, sigmas, state):
    """test_parallel_sampler.py's stateless contraction toward a fixed attractor."""
    target = torch.sin(torch.arange(TN * TC, dtype=x.dtype)).reshape(1, TN, TC)
    s = sigmas.reshape(-1, 1, 1)
    return (x + s * target) / (1.0 + s), state


def _toy_stateful(x, sigmas, state):
    base, _ = _toy(x, sigmas, None)
    return (base + 0.05 * torch.tanh(state),
            0.9 * state + 0.1 * x.mean(dim=1, keepdim=True) * torch.ones_like(state))


# The JAX package is imported where the JAX side runs, in this process only: the rank
# processes import this module and run the port alone.

def _jax_toy(x, sigmas, state):
    import jax.numpy as jnp

    target = jnp.sin(jnp.arange(TN * TC, dtype=x.dtype)).reshape(1, TN, TC)
    s = sigmas.reshape(-1, 1, 1)
    return (x + s * target) / (1.0 + s), state


def _jax_toy_stateful(x, sigmas, state):
    import jax.numpy as jnp

    base, _ = _jax_toy(x, sigmas, None)
    return (base + 0.05 * jnp.tanh(state),
            0.9 * state + 0.1 * jnp.mean(x, axis=1, keepdims=True) * jnp.ones_like(state))


TOYS = {"stateless": (_toy, _jax_toy), "stateful": (_toy_stateful, _jax_toy_stateful)}


# ------------------------------------------------------------------ the inputs and weights

@functools.lru_cache(maxsize=1)
def _inputs():
    """The inputs from numpy seeds; the backbone's and the extractor's weights made by the
    port from a seed and carried to the JAX side (``flax_from_params``; the extractor's as
    the reference's ``state_dict``, which the JAX package imports)."""
    import jax

    from pcdiff.diffusion import get_sigmas_karras
    from pcdiff.evals.pointnet2 import import_pointnet2_torch_state

    rng = np.random.default_rng(0)

    def qkv(nq, nk):
        return (rng.standard_normal((B, H, nq, D)).astype(np.float32) * 0.3,
                rng.standard_normal((B, H, nk, D)).astype(np.float32) * 0.3,
                rng.standard_normal((B, H, nk, D)).astype(np.float32))

    prims = {"read": qkv(24, 64), "write": qkv(64, 24), "head": qkv(24, 24)}
    prim_w = {k: rng.standard_normal((B, H, v[0].shape[2], D)).astype(np.float32)
              for k, v in prims.items()}
    backbone = init_params(DenoiserBackbone(**_backbone_kwargs()),
                           torch.Generator().manual_seed(0))
    with torch.no_grad():  # zero at init: give the self-conditioning LayerNorm weights
        backbone.ln_latent.weight.normal_(generator=torch.Generator().manual_seed(1))
    pn_state = md.seeded_extractor_state(1, 0)
    return dict(
        prims=prims, prim_w=prim_w,
        x=rng.standard_normal((BB, NUM_X, 3)).astype(np.float32), t=np.asarray([3, 70]),
        cond=rng.standard_normal((BB, N_COND, DIM)).astype(np.float32),
        state={k: v.detach().clone() for k, v in backbone.state_dict().items()},
        params={"params": flax_from_params(backbone)},
        wo=rng.standard_normal((BB, NUM_X, 3)).astype(np.float32),
        wz=rng.standard_normal((BB, NUM_Z + N_COND + 1, DIM)).astype(np.float32),
        x_T=np.asarray(jax.random.normal(jax.random.PRNGKey(8), (TB, TN, TC)) * 40.0),
        sigmas=np.asarray(get_sigmas_karras(STEPS, 1e-3, 40.0)),
        clouds=rng.standard_normal((CLOUDS, CLOUD_POINTS, 3)).astype(np.float32),
        pointnet=import_pointnet2_torch_state(pn_state), pointnet_state=pn_state)


def _shard(a, i, dim, n=WORLD):
    per = a.shape[dim] // n
    return np.take(a, np.arange(i * per, (i + 1) * per), axis=dim)


# ------------------------------------------------------------------ the ranks

def _primitive(name, q, k, v, mesh):
    fn = {"read": xsp.sharded_read_attention, "write": xsp.sharded_write_attention,
          "head": xsp.sharded_head_attention}[name]
    return fn(q, k, v, mesh)


def _backbone(state, mesh, head):
    hooks = dict(read_attention_fn=functools.partial(xsp.sharded_read_attention, mesh=mesh),
                 write_attention_fn=functools.partial(xsp.sharded_write_attention, mesh=mesh))
    if head:
        hooks["compute_attention_fn"] = functools.partial(xsp.sharded_head_attention,
                                                          mesh=mesh)
    model = DenoiserBackbone(**_backbone_kwargs(), **hooks)
    model.load_state_dict(state)
    return model


def _pair_task(inp):
    """Every two-rank check, this rank's results."""
    import torch.distributed as dist

    rank = dist.get_rank()
    out = {}
    mesh = md._mesh(1, WORLD)
    for name, (q, k, v) in inp["prims"].items():
        if name == "read":
            k, v = _shard(k, rank, 2), _shard(v, rank, 2)
        elif name == "write":
            q = _shard(q, rank, 2)
        q, k, v = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
        o = _primitive(name, q, k, v, mesh)
        w = inp["prim_w"][name]
        w = torch.as_tensor(_shard(w, rank, 2) if name == "write" else w)
        loss = (o * w).sum()
        if name == "write":  # the output is sharded: the loss is the sum of the ranks' parts
            loss = sum_partials(loss, mesh)
        loss.backward()
        out[name] = [t.detach() for t in (o, q.grad, k.grad, v.grad)]

    for head in (False, True):
        model = _backbone(inp["state"], mesh, head)
        x = torch.tensor(_shard(inp["x"], rank, 1), requires_grad=True)
        eps, z = model(x, torch.as_tensor(inp["t"]), torch.as_tensor(inp["cond"]))
        res = dict(eps=eps.detach(), z=z.detach())
        if not head:
            loss = (sum_partials((eps * torch.as_tensor(_shard(inp["wo"], rank, 1))).sum(), mesh)
                    + (z * torch.as_tensor(inp["wz"])).sum())
            loss.backward()
            xsp.sum_point_gradients(model.point_parameters(), mesh)
            res.update(dx=x.grad, grads={n: p.grad.clone() for n, p in model.named_parameters()})
        out["backbone_head" if head else "backbone"] = res

    mesh = md._mesh(WORLD, 1)
    for name, (toy, _) in TOYS.items():
        state = None if name == "stateless" else torch.zeros(TB, 1, TC)
        r = sample_heun_parallel(toy, torch.as_tensor(inp["x_T"]), inp["sigmas"], state=state,
                                 window=8, tol=1e-3, window_spec="data", mesh=mesh)
        out[f"toy_{name}"] = dict(x=r["x"], iters=r["parallel_iters"],
                                  state=None if state is None else r["state"])
    ext = PointNetClassifier(state_dict=inp["pointnet_state"], batch_size=CHUNK, width_mult=1,
                             device="cpu", mesh=mesh)
    out["extractor"] = ext.features_and_preds(inp["clouds"])
    return out


@pytest.fixture(scope="module")
def ranks():
    inp = {k: v for k, v in _inputs().items() if k not in ("params", "pointnet")}
    return md.run_ranks(_pair_task, WORLD, "gloo", "cpu", inp)  # the port's parts only


# ------------------------------------------------------------------ the primitives

def _jax_primitive(name, q, k, v):
    import jax
    import jax.numpy as jnp

    from pcdiff.parallel import make_mesh as jax_make_mesh
    from pcdiff.parallel import xsp as jxsp

    mesh = jax_make_mesh(jax.devices()[:WORLD], data_parallel=1, model_parallel=WORLD)
    fn = {"read": jxsp.sharded_read_attention, "write": jxsp.sharded_write_attention,
          "head": jxsp.sharded_head_attention}[name]
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh))


@pytest.mark.parametrize("name", ["read", "write", "head"])
def test_primitive_matches_jax(ranks, name):
    q, k, v = _inputs()["prims"][name]
    want = _jax_primitive(name, q, k, v)
    for rank, res in enumerate(ranks):
        got = res[name][0].numpy()
        if name == "write":  # each rank holds its queries' rows
            want_r = _shard(want, rank, 2)
        else:
            want_r = want
        np.testing.assert_allclose(got, want_r, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["read", "write", "head"])
def test_primitive_gradients_are_the_dense_ones(ranks, name):
    """dq, dk, dv of sum(out * w), every rank computing the same loss, against the dense
    attention's autograd: a replicated input's gradient whole on every rank, a shard's its
    rows of the dense gradient."""
    q, k, v = (torch.tensor(a, requires_grad=True) for a in _inputs()["prims"][name])
    (xsp.local_attention(q, k, v) * torch.as_tensor(_inputs()["prim_w"][name])).sum().backward()
    for rank, res in enumerate(ranks):
        _, dq, dk, dv = res[name]
        wq, wk, wv = q.grad.numpy(), k.grad.numpy(), v.grad.numpy()
        if name == "read":
            wk, wv = _shard(wk, rank, 2), _shard(wv, rank, 2)
        elif name == "write":
            wq = _shard(wq, rank, 2)
        for got, want in ((dq, wq), (dk, wk), (dv, wv)):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ the backbone

@functools.lru_cache(maxsize=1)
def _jax_dense():
    import jax
    import jax.numpy as jnp

    from pcdiff.models.rin import DenoiserBackbone as JaxBackbone

    inp = _inputs()
    eps, z = jax.jit(JaxBackbone(**_backbone_kwargs()).apply)(
        inp["params"], jnp.asarray(inp["x"]), jnp.asarray(inp["t"]), jnp.asarray(inp["cond"]))
    return np.asarray(eps), np.asarray(z)


@pytest.mark.parametrize("key", ["backbone", "backbone_head"],
                         ids=["read_write_sharded", "and_head_parallel_compute"])
def test_sharded_backbone_matches_the_jax_dense_backbone(ranks, key):
    want_eps, want_z = _jax_dense()
    for rank, res in enumerate(ranks):
        np.testing.assert_allclose(res[key]["eps"].numpy(), _shard(want_eps, rank, 1),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(res[key]["z"].numpy(), want_z, rtol=1e-4, atol=1e-5)


def test_sharded_backbone_gradients_match_one_process(ranks):
    """The loss every rank computes alike (the points' term summed over the ranks), its
    gradients after ``sum_point_gradients``: each parameter's whole on every rank and the
    input's rows, against one process's dense backbone (the primitives' plain version as
    its read and write hooks)."""
    inp = _inputs()
    model = DenoiserBackbone(**_backbone_kwargs(), read_attention_fn=xsp.local_attention,
                             write_attention_fn=xsp.local_attention)
    model.load_state_dict(inp["state"])
    x = torch.tensor(inp["x"], requires_grad=True)
    eps, z = model(x, torch.as_tensor(inp["t"]), torch.as_tensor(inp["cond"]))
    ((eps * torch.as_tensor(inp["wo"])).sum() + (z * torch.as_tensor(inp["wz"])).sum()).backward()
    want = {n: p.grad for n, p in model.named_parameters()}
    flat_want = torch.cat([g.reshape(-1) for g in want.values()])
    for rank, res in enumerate(ranks):
        got = res["backbone"]["grads"]
        flat = torch.cat([got[n].reshape(-1) for n in want])
        assert ((flat - flat_want).norm() / flat_want.norm()).item() <= 1e-5
        for n, g in want.items():  # no tensor off by a factor: each within 1e-5 of the norm
            assert (got[n] - g).norm().item() <= 1e-5 * flat_want.norm().item(), n
        dx = res["backbone"]["dx"]
        want_dx = torch.as_tensor(_shard(x.grad.numpy(), rank, 1))
        assert ((dx - want_dx).norm() / want_dx.norm()).item() <= 1e-5


# ------------------------------------------------------------------ the window, the extractor

@pytest.mark.parametrize("name", list(TOYS))
def test_window_sharded_heun_parallel_matches_jax(ranks, name):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from pcdiff.diffusion import sample_heun_parallel as jax_heun_parallel
    from pcdiff.parallel import make_mesh as jax_make_mesh

    inp = _inputs()
    mesh = jax_make_mesh(jax.devices()[:WORLD], data_parallel=WORLD, model_parallel=1)
    state = None if name == "stateless" else jnp.zeros((TB, 1, TC))
    run = jax.jit(lambda x: jax_heun_parallel(
        TOYS[name][1], x, inp["sigmas"], jax.random.PRNGKey(9), state=state, window=8,
        tol=1e-3, window_spec=P("data"), mesh=mesh))
    with mesh:
        want = run(jnp.asarray(inp["x_T"]))
    for res in ranks:
        got = res[f"toy_{name}"]
        assert got["iters"] == int(want["parallel_iters"])
        np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]), rtol=1e-5,
                                   atol=1e-6)
        if state is not None:
            np.testing.assert_allclose(got["state"].numpy(), np.asarray(want["state"]),
                                       rtol=1e-5, atol=1e-6)


def test_sharded_extractor_matches_one_process_and_jax(ranks):
    """Two chunks of 8 (the last padded), 4 rows a rank: FPS starting each cloud at its
    index in the chunk gives one process's features and probabilities, and the JAX
    package's ``mesh=`` extractor's."""
    import jax

    from pcdiff.evals.feature_extractor import PointNetClassifier as JaxClassifier
    from pcdiff.parallel import make_mesh as jax_make_mesh

    inp = _inputs()
    one = PointNetClassifier(state_dict=inp["pointnet_state"], batch_size=CHUNK,
                             width_mult=1, device="cpu")
    f0, p0 = one.features_and_preds(inp["clouds"])
    mesh = jax_make_mesh(jax.devices()[:WORLD], data_parallel=WORLD, model_parallel=1)
    fj, pj = JaxClassifier(params=inp["pointnet"], batch_size=CHUNK, width_mult=1,
                           mesh=mesh).features_and_preds(inp["clouds"])
    for f, p in (r["extractor"] for r in ranks):
        np.testing.assert_allclose(f, f0, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(p, p0, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(f, fj, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(p, pj, rtol=1e-5, atol=1e-6)


def test_extractor_batch_must_divide_over_the_data_axis():
    class Mesh:  # a (3, 1) mesh's surface, as the extractor reads it
        mesh_dim_names = ("data", "model")

        def get_local_rank(self, axis):
            return 0

        def size(self, dim):
            return (3, 1)[dim]

    with pytest.raises(ValueError, match="must divide"):
        PointNetClassifier(state_dict=_inputs()["pointnet_state"], batch_size=CHUNK,
                           width_mult=1, device="cpu", mesh=Mesh())


# ------------------------------------------------------------------ the hooks, the dryrun

def test_hooks_set_the_point_shards():
    """A read hook bound to a mesh shards the points (the model then takes its share); a
    sharded write hook without it, or over another mesh, is refused; unbound hooks shard
    nothing."""
    class Mesh:
        mesh_dim_names = ("data", "model")

        def get_local_rank(self, axis):
            return 1

        def size(self, dim):
            return (1, 4)[dim]

    mesh, other = Mesh(), Mesh()
    read = functools.partial(xsp.sharded_read_attention, mesh=mesh)
    write = functools.partial(xsp.sharded_write_attention, mesh=mesh)
    assert xsp.point_mesh(read, write) == (mesh, MODEL_AXIS)
    assert xsp.point_mesh(read, xsp.local_attention) == (mesh, MODEL_AXIS)
    assert xsp.point_mesh(xsp.local_attention, xsp.local_attention) is None
    for bad in ((xsp.local_attention, write),
                (functools.partial(xsp.sharded_read_attention, mesh=other), write)):
        with pytest.raises(ValueError, match="write hook"):
            xsp.point_mesh(*bad)
    with pytest.raises(ValueError, match="by keyword"):
        xsp.point_mesh(functools.partial(xsp.sharded_read_attention, q=None), None)
    cfg = dict(md.TINY, read_attention_fn=read, write_attention_fn=write)
    assert TwoStreamDenoiser(**cfg, device="cpu").backbone.local_x == md.TINY["num_points"] // 4
    with pytest.raises(ValueError, match="do not split"):
        TwoStreamDenoiser(**dict(cfg, num_points=30), device="cpu")


def test_dryrun_runs_on_four_cpu_ranks():
    """``python -m pcdiff_torch.scripts.multichip_dryrun --device cpu --ranks 4``: every
    phase within its bound (the composed window x points sample within 1e-3 of the dense
    ``heun``, as test_parallel_sampler.py:177-233 holds the JAX package's)."""
    res = md.main(["--device", "cpu", "--ranks", "4"])
    assert (res["world"], res["backend"], res["device"]) == (4, "gloo", "cpu")
    assert res["dp"]["loss_rel"] <= md.STEP_REL
    assert res["sp"]["eps_rel"] <= md.SP_REL_L2 and res["sp"]["cloud_err"] <= md.CLOUD_ATOL
    assert res["composed"]["err"] <= md.CLOUD_ATOL
    assert res["picard"]["x_rel"] <= md.PICARD_REL and res["extractor"]["rel"] <= md.FEATURE_REL


def test_one_process_references_match_the_plain_attention_and_model():
    """The references phase 24 of ``chip_smoke.py`` holds the ranks to: the read attention
    summed over two key shards in one process, and a model whose calls run as two halves of
    their rows, compute what the plain attention and the whole call compute."""
    q, k, v = (torch.as_tensor(a) for a in _inputs()["prims"]["read"])
    torch.testing.assert_close(md.split_read_attention(q, k, v, 2), xsp.local_attention(q, k, v),
                               rtol=1e-5, atol=1e-6)
    data = md.make_inputs(md.TINY, 4, 0)
    cpu = torch.device("cpu")
    whole = md.call(md.build_model(md.TINY, cpu, 0), data, cpu)
    halves = md.call(md.chunked(md.build_model(md.TINY, cpu, 0), 2), data, cpu)
    torch.testing.assert_close(halves["eps"], whole["eps"], rtol=1e-5, atol=1e-6)
