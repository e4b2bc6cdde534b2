"""A dry run of the port's multi-rank paths: data parallelism, the x-stream's points sharded
over ranks, the Picard window sharded over ranks and the P-FID extractor's rows sharded
over ranks, each held against one process on the same inputs.

Counterpart of ``__graft_entry__.dryrun_multichip`` phases 1-4 and of the checks of
``scripts/multiprocess_dryrun.py``. N rank processes, started by ``torch.multiprocessing``
and joined through a ``FileStore``, run on the tiny denoiser with seeded weights:

1. **dp**: one train step on a (N, 1) mesh, each rank its rows of a global batch of 2N;
   the ranks hold one model after it, bit for bit, and its loss is the one process's on the
   whole batch; the loader's shards are disjoint, ``fold_in_process`` gives each rank its
   own stream, and rank 0's checkpoint restores on every rank;
2. **dp x sp**: one denoiser call on a (N / 2, 2) mesh (N even), the batch over ``data``
   and the points over ``model`` through the sharded read and write attentions, and
   head-parallel compute attentions;
3. **sp sampling**: an 8-step Karras CFG ``heun`` sample on that mesh; and both
   parallelisms at once there: ``heun_parallel`` (6 steps, window 4, tol 1e-3) with the
   window over ``data`` and the points over ``model``, against the dense ``heun`` (as
   ``tests/test_parallel_sampler.py:177-233``);
4. **parallel in time**: ``heun_parallel`` with its window of N sharded over ``data`` of a
   (N, 1) mesh, which must take the one process's Picard rounds;

then the extractor's chunk sharded over the (N, 1) mesh's ``data``: the same FPS indices
and features as one process. The one-process references run in the launching process after
the ranks, with the sharded attentions' plain versions as the hooks
(:func:`pcdiff_torch.parallel.xsp.local_attention`). Each phase prints one line with the
world, the mesh and a fingerprint (the sum of |values|). On the card the ranks take a card
each on NCCL, or share one on gloo (``--backend gloo``, the default when there are more
ranks than cards); ``--device cpu`` runs gloo on the CPU:

    python -m pcdiff_torch.scripts.multichip_dryrun [--ranks 4] [--device cuda|cpu]
        [--backend nccl|gloo]

:func:`run_ranks` and :func:`sharded_paths_task` are what ``chip_smoke.py`` runs at the
flagship's width.
"""

from __future__ import annotations

import argparse
import functools
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

# the JAX package's dryrun model (``__graft_entry__._flagship_setup(tiny=True)``)
TINY = dict(num_points=32, num_latents=8, latent_dim=16, x_dim=16, num_blocks=1,
            num_compute_layers=1, num_heads=2, num_classes=10, num_tokens_ppcd=4,
            num_tokens_depth=2, depth_image_size=32, depth_patch=16)
SP_REL_L2 = 1e-4  # a sharded call against the one process's (fp32; sums in another order)
CLOUD_ATOL = 1e-3  # a sharded sample's cloud (tests/test_parallel_sampler.py:233's bound)
PICARD_REL = 1e-5  # the window-sharded heun_parallel's cloud, in equal Picard rounds
FEATURE_REL = 1e-5  # the sharded extractor's features and probabilities
STEP_REL = 1e-5  # the data-parallel step's loss against one process on the whole batch
# A CFG Heun sample of a random-weight model in few steps amplifies the sharded call's
# reordered sums (rel 2e-7 a call): from sigma 120 in 8 steps to 5e-3 in the tiny model's
# cloud on a (2, 2) mesh, from 40 to 2.4e-4, from 120 in 64 steps to 3e-6. So the dryrun's
# samples start at tests/test_parallel_sampler.py's sigma_max.
SAMPLE_SIGMA_MAX = 40.0


# ------------------------------------------------------------------ the rank processes

def run_ranks(task: Callable, ranks: int, backend: str, device: str, *args) -> List[Any]:
    """``task(*args)`` in each of ``ranks`` processes joined in one process group of
    ``backend`` (a ``FileStore`` in a temporary directory); their results in rank order.
    On the card rank r takes card r mod the cards' count. A task returns CPU tensors."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="pcdiff_ranks_") as tmp:
        mp.start_processes(_rank_main, args=(ranks, backend, device, tmp, task, args),
                           nprocs=ranks, join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(ranks)]


def _rank_main(rank: int, ranks: int, backend: str, device: str, tmp: str, task: Callable,
               args: tuple) -> None:
    import torch.distributed as dist

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)  # the ranks share the host's cores
    store = dist.FileStore(os.path.join(tmp, "store"), ranks)
    dist.init_process_group(backend, store=store, world_size=ranks, rank=rank)
    try:
        out = task(*args)
        torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _device(device: str) -> torch.device:
    if torch.device(device).type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _mesh(dp: int, mp: int):
    from ..parallel import make_mesh

    return make_mesh(data_parallel=dp, model_parallel=mp)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _counts() -> Dict[str, int]:
    from ..ops import flash_attention as fa
    from ..ops import layer_norm as tln
    from ..ops import ln_dense as ld
    from ..ops import ln_mlp as lm

    return {"attention_mh": fa.launches, "ln_dense": ld.launches, "ln_mlp": lm.launches,
            "layer_norm": tln.launches}


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _counts().items()}


# ------------------------------------------------------------------ models and inputs

def build_model(cfg: dict, dev, seed: int, mesh=None, head: bool = False,
                reference: bool = False, read_shards: int = 0):
    """The TwoStreamDenoiser of ``cfg`` on ``dev`` with the weights of ``seed``, in eval
    mode. With ``mesh`` its read and write hooks shard the points over the mesh's
    ``model`` axis (and with ``head`` its compute attentions shard the heads); with
    ``reference`` those hooks are the sharded attentions' one-process plain version, its
    read attention :func:`split_read_attention` over ``read_shards`` if given."""
    from ..core import init_params
    from ..models import TwoStreamDenoiser
    from ..parallel import xsp

    if reference:
        read = (functools.partial(split_read_attention, shards=read_shards) if read_shards
                else xsp.local_attention)
        hooks = dict(read_attention_fn=read, write_attention_fn=xsp.local_attention)
        if head:
            hooks["compute_attention_fn"] = xsp.local_attention
    elif mesh is not None:
        hooks = dict(read_attention_fn=functools.partial(xsp.sharded_read_attention, mesh=mesh),
                     write_attention_fn=functools.partial(xsp.sharded_write_attention,
                                                          mesh=mesh))
        if head:
            hooks["compute_attention_fn"] = functools.partial(xsp.sharded_head_attention,
                                                              mesh=mesh)
    else:
        hooks = {}
    model = TwoStreamDenoiser(**cfg, device=dev, **hooks)
    init_params(model, torch.Generator(device=dev).manual_seed(seed))
    return model.eval()


def split_read_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, shards: int
                         ) -> torch.Tensor:
    """:func:`pcdiff_torch.parallel.xsp.sharded_read_attention` over ``shards`` equal key
    shards, in one process and in its arithmetic: each shard's fp32 logits, the max of the
    shards' row maxes, each shard's exponentials and partial sums, added in shard order (a
    sum of two is the same in either order, as two ranks' all-reduce adds them). The
    one-process reference whose sums are the ranks'."""
    ks, vs = k.chunk(shards, dim=2), v.chunk(shards, dim=2)
    logits = [torch.matmul(q.float(), kk.float().transpose(-1, -2)) for kk in ks]
    m = functools.reduce(torch.maximum, [lg.amax(dim=-1) for lg in logits])
    ps = [torch.exp(lg - m[..., None]) for lg in logits]
    denom = functools.reduce(torch.add, [p.sum(dim=-1) for p in ps])
    out = functools.reduce(torch.add, [torch.matmul(p.to(vv.dtype), vv).float()
                                       for p, vv in zip(ps, vs)])
    return (out / denom[..., None]).to(q.dtype)


def chunked(model, chunks: int):
    """``model`` with each call run as ``chunks`` equal calls over the batch's rows, their
    outputs concatenated: in one process, the rows a call has on each of ``chunks`` ranks
    that split a window (a card's kernels may pick their tiling, and so their roundings, by
    the rows of a call). Returns ``model``."""
    forward = model.forward

    def split(v, rows):
        if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == rows:
            return v.chunk(chunks)
        return [v] * chunks

    def run(x, t, **kwargs):
        rows = x.shape[0]
        parts = [split(v, rows) for v in (x, t)]
        kw = {k: split(v, rows) for k, v in kwargs.items()}
        outs = [forward(parts[0][i], parts[1][i], **{k: v[i] for k, v in kw.items()})
                for i in range(chunks)]
        return tuple(torch.cat(o) for o in zip(*outs))

    model.forward = run
    return model


def make_inputs(cfg: dict, batch: int, seed: int) -> Dict[str, np.ndarray]:
    """A call's inputs from ``seed``: x [B, N, 3] ~ N(0, 1), t [B] in [0, 1000) and the
    conditioning of a synthetic batch."""
    from ..data import synthetic_batch

    rng = np.random.default_rng(seed)
    out = synthetic_batch(rng, batch, cfg["num_points"], cfg["num_points"],
                          cfg["depth_image_size"], cfg["num_classes"])
    out["x"] = rng.standard_normal((batch, cfg["num_points"], 3)).astype(np.float32)
    out["t"] = rng.integers(0, 1000, (batch,)).astype(np.int64)
    return out


_COND = ("class_labels", "viewpoints", "partial_pcd", "depth_maps")


def make_sampler(model, steps: int, num_points: int, sampler: str = "heun",
                 parallel_options: Optional[dict] = None,
                 sigma_max: float = SAMPLE_SIGMA_MAX):
    """A one-stage CFG (scale 3) Karras sampler of ``steps`` over ``model`` (linear
    schedule of 100 steps, as the JAX dryrun's, sigma from ``sigma_max`` to 1e-3, no churn): (sampler, its bound model)."""
    from ..diffusion import diffusion_from_betas
    from ..diffusion.sampler import PointCloudSampler
    from ..models.wrapper import BoundTwoStream

    bound = BoundTwoStream(model)
    return PointCloudSampler(
        models=[bound], diffusions=[diffusion_from_betas("linear", 100)],
        num_points=[num_points], aux_channels=[], guidance_scale=[3.0], clip_denoised=True,
        use_karras=[True], karras_steps=[steps], sigma_min=[1e-3], sigma_max=[sigma_max],
        s_churn=[0.0], sampler=sampler, parallel_options=parallel_options), bound


def call_inputs(model, data: Dict[str, np.ndarray], dev, mesh=None) -> tuple:
    """(x, t, cond_tokens) of a call on ``data``: with a mesh this data rank's rows and this
    rank's points of x; the conditioning encoded once, as the sampler does."""
    from ..parallel.mesh import shard_batch
    from ..parallel.xsp import local_points

    rows = shard_batch(mesh, data) if mesh is not None else data
    x = local_points(torch.as_tensor(rows["x"], device=dev), model.backbone.point_mesh)
    with torch.no_grad():
        cond = model.encode_conditioning(
            x.shape[0], **{k: torch.as_tensor(rows[k], device=dev) for k in _COND})
    return x, torch.as_tensor(rows["t"], device=dev), cond


def call(model, data: Dict[str, np.ndarray], dev, mesh=None) -> Dict[str, Any]:
    """One denoiser call on ``data`` (:func:`call_inputs`; the points and rows put back
    together after it): ``eps``, its seconds and this rank's kernel launches in it."""
    from ..parallel.mesh import DATA_AXIS, gather_shares
    from ..parallel.xsp import gather_points

    x, t, cond = call_inputs(model, data, dev, mesh)
    with torch.no_grad():
        before = _counts()
        _sync(dev)
        t0 = time.perf_counter()
        eps, _ = model(x, t, cond_tokens=cond)
        counts = _delta(before)
        eps = gather_points(eps, model.backbone.point_mesh)
        if mesh is not None:
            eps = gather_shares(eps, mesh, DATA_AXIS, dim=0)
        _sync(dev)
        seconds = time.perf_counter() - t0
    return dict(eps=eps.float().cpu(), seconds=seconds, counts=counts)


def sample(model, cfg: dict, data: Dict[str, np.ndarray], steps: int, seed: int, dev,
           sigma_max: float = SAMPLE_SIGMA_MAX) -> Dict[str, Any]:
    """A ``steps``-step CFG ``heun`` sample of ``data``'s whole batch from a generator of
    ``seed``: ``cloud``, its seconds, this rank's kernel launches and the calls."""
    sampler, bound = make_sampler(model, steps, cfg["num_points"], sigma_max=sigma_max)
    kwargs = {k: torch.as_tensor(data[k], device=dev) for k in _COND}
    with torch.no_grad():
        before = _counts()
        _sync(dev)
        t0 = time.perf_counter()
        cloud = sampler.sample_batch(len(data["x"]), kwargs,
                                     torch.Generator(device=dev).manual_seed(seed))
        _sync(dev)
    return dict(cloud=cloud.float().cpu(), seconds=time.perf_counter() - t0,
                counts=_delta(before), calls=bound.calls)


def picard_sample(model, cfg: dict, data: Dict[str, np.ndarray], steps: int, window: int,
                  tol: float, seed: int, dev, mesh=None,
                  sigma_max: float = SAMPLE_SIGMA_MAX) -> Dict[str, Any]:
    """A ``steps``-step CFG ``heun_parallel`` sample (``window``, ``tol``) of ``data``'s
    batch; with ``mesh`` its window is sharded over the mesh's ``data`` axis. ``cloud``,
    ``parallel_iters``, seconds and the calls' rows."""
    from ..parallel.mesh import DATA_AXIS

    opts = dict(window=window, tol=tol)
    if mesh is not None:
        opts.update(window_spec=DATA_AXIS, mesh=mesh)
    sampler, bound = make_sampler(model, steps, cfg["num_points"], "heun_parallel", opts,
                                  sigma_max)
    kwargs = {k: torch.as_tensor(data[k], device=dev) for k in _COND}
    with torch.no_grad():
        _sync(dev)
        t0 = time.perf_counter()
        cloud = sampler.sample_batch(len(data["x"]), kwargs,
                                     torch.Generator(device=dev).manual_seed(seed))
        _sync(dev)
    return dict(cloud=cloud.float().cpu(), parallel_iters=sampler.parallel_iters[0],
                seconds=time.perf_counter() - t0, calls=bound.calls)


def seeded_extractor_state(width: int, seed: int) -> Dict[str, torch.Tensor]:
    """A 40-class PointNet++ of ``width`` from ``seed``, batch-norm statistics randomised
    (means U(-0.2, 0.2), variances U(0.8, 1.2)), as a reference ``state_dict``."""
    from ..core import init_params
    from ..evals.pointnet2 import BatchNorm, PointNet2ClassifierSSG

    gen = torch.Generator().manual_seed(seed)
    net = init_params(PointNet2ClassifierSSG(num_class=40, width_mult=width), gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.8, 1.2, generator=gen)
    return net.state_dict()


def extract(clouds: np.ndarray, width: int, seed: int, dev, mesh=None,
            dtype=np.float32) -> Dict[str, Any]:
    """One chunk of ``clouds`` through the extractor (sharded over ``mesh``'s ``data``):
    features, probabilities, sa1's FPS indices (each rank's rows from their index in the
    chunk, put back together), seconds."""
    from ..evals.feature_extractor import PointNetClassifier, normalize_point_clouds
    from ..geometry.fps import farthest_point_sample
    from ..parallel.mesh import DATA_AXIS, axis_rank, gather_shares

    ext = PointNetClassifier(state_dict=seeded_extractor_state(width, seed),
                             batch_size=len(clouds), width_mult=width, dtype=dtype,
                             device=dev, mesh=mesh)
    _sync(dev)
    t0 = time.perf_counter()
    feats, preds = ext.features_and_preds(clouds)
    _sync(dev)
    seconds = time.perf_counter() - t0
    rank, ranks = axis_rank(mesh, DATA_AXIS)
    per = len(clouds) // ranks
    pc = torch.as_tensor(normalize_point_clouds(np.asarray(clouds, dtype)), device=dev)
    idx = farthest_point_sample(pc[rank * per:(rank + 1) * per], 512, deterministic=True,
                                row_offset=rank * per)
    if mesh is not None:
        idx = gather_shares(idx, mesh, DATA_AXIS, dim=0)
    return dict(features=feats, preds=preds, fps=idx.cpu(), seconds=seconds)


# ------------------------------------------------------------------ the tasks

def _collectives(dev) -> Dict[str, bool]:
    """Which of the collectives the model axis uses took this device's tensors and gave
    the right values, over the whole group: all_reduce SUM and MAX, broadcast."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    t = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    out = {"all_reduce SUM": bool((t == world * (world + 1) / 2).all())}
    t = torch.full((4,), float(rank + 1), device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    out["all_reduce MAX"] = bool((t == world).all())
    t = torch.full((4,), float(rank + 7), device=dev)
    dist.broadcast(t, src=0)
    out["broadcast"] = bool((t == 7).all())
    return out


def sharded_paths_task(cfg: dict, call_rows: int, sample_batch: int, steps: int,
                       sigma_max: float, window: int, tol: float, clouds: np.ndarray,
                       width: int, seed: int, device: str, libraries: Sequence[str] = ()
                       ) -> Dict[str, Any]:
    """Two ranks, the three sharded sampling paths in turn: ``libraries`` loaded at once
    (built where missing: the ranks race for them), the collectives' check, then on a
    (1, 2) mesh :func:`call` and :func:`sample` (``steps`` from ``sigma_max``) of the
    points-sharded model, on a (2, 1) mesh :func:`picard_sample` with the window over
    ``data``, and :func:`extract` of ``clouds``; ``built``: the libraries this rank
    compiled."""
    from concurrent.futures import ThreadPoolExecutor

    from ..ops import _native

    if libraries:
        with ThreadPoolExecutor(len(libraries)) as pool:
            list(pool.map(_native.library, libraries))
    dev = _device(device)
    out: Dict[str, Any] = {"collectives": _collectives(dev)}
    mesh = _mesh(1, 2)
    model = build_model(cfg, dev, seed, mesh)
    out["call"] = call(model, make_inputs(cfg, call_rows, seed), dev, mesh)
    data = make_inputs(cfg, sample_batch, seed)
    out["sample"] = sample(model, cfg, data, steps, seed, dev, sigma_max)
    del model
    mesh = _mesh(2, 1)
    out["picard"] = picard_sample(build_model(cfg, dev, seed), cfg, data, steps, window, tol,
                                  seed, dev, mesh, sigma_max)
    out["extractor"] = extract(clouds, width, seed, dev, mesh)
    out["built"] = sorted(_native.build_seconds)
    return out


class _Items:
    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int, rng=None) -> Dict[str, np.ndarray]:
        return {"i": np.int64(i)}


def train_batch(cfg: dict, batch: int, seed: int) -> Dict[str, np.ndarray]:
    from ..data import synthetic_batch

    return synthetic_batch(np.random.default_rng(seed), batch, cfg["num_points"],
                           cfg["num_points"] // 2, cfg["depth_image_size"], cfg["num_classes"])


def train_step(cfg: dict, batch: Dict[str, np.ndarray], seed: int, dev, mesh=None):
    """One train step (linear schedule of 100 steps, self-conditioning 1, chamfer on) of
    the seeded model on ``batch`` (with a mesh: this rank's rows, the gradients averaged
    over ``data``): (state, metrics)."""
    from ..diffusion import diffusion_from_betas
    from ..parallel import replicate, shard_batch
    from ..parallel.mesh import data_group
    from ..train import create_train_state, make_train_step

    model = build_model(cfg, dev, seed)
    replicate(mesh, model)
    state = create_train_state(model, lr=1e-3, total_steps=10, device=dev)
    step = make_train_step(model, diffusion_from_betas("linear", 100),
                           self_conditioning_prob=1.0, data_group=data_group(mesh), device=dev)
    metrics = step(state, shard_batch(mesh, batch),
                   torch.Generator(device=dev).manual_seed(seed), True)
    return state, metrics


def _flat(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).float().cpu() for p in model.parameters()])


def dp_phase(cfg: dict, seed: int, dev, mesh, ckpt_dir: str) -> Dict[str, Any]:
    """Phase 1 on the (N, 1) ``mesh``: the data-parallel train step on a global batch of
    2N, the loader's shards, ``fold_in_process`` and a checkpoint written by rank 0 and
    restored on every rank."""
    import torch.distributed as dist

    from ..core.checkpoint import restore_checkpoint, save_checkpoint
    from ..data import BatchLoader
    from ..parallel import fold_in_process
    from ..parallel.mesh import DATA_AXIS, gather_shares, sum_partials
    from ..train import create_train_state

    world, rank = dist.get_world_size(), dist.get_rank()
    state, metrics = train_step(cfg, train_batch(cfg, 2 * world, seed), seed, dev, mesh)
    items = 6 * world + 1  # one left over
    loader = BatchLoader(_Items(items), 2, seed=seed, process_index=rank,
                         process_count=world, prefetch=0)
    hits = torch.zeros(items, device=dev)
    hits[torch.as_tensor(loader.epoch_indices().ravel(), device=dev)] += 1
    hits = sum_partials(hits, mesh, DATA_AXIS)
    fold = torch.rand((1,), generator=fold_in_process(seed)).to(dev)
    folds = gather_shares(fold, mesh, DATA_AXIS, dim=0)
    if rank == 0:
        save_checkpoint(ckpt_dir, 1, state)
    dist.barrier()
    fresh = create_train_state(build_model(cfg, dev, seed + 1), lr=1e-3, total_steps=10,
                               device=dev)
    _, step = restore_checkpoint(ckpt_dir, fresh)
    return dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                params=_flat(state.model), hits=hits.cpu(), folds=folds.cpu(),
                restored=torch.equal(_flat(fresh.model), _flat(state.model)),
                restored_step=step)


def window_of(n: int) -> int:
    """The dryrun's Picard window over n ranks: 8 steps' worth split evenly."""
    return n if 8 % n == 0 else 8 // n * n


def dryrun_task(cfg: dict, seed: int, device: str, ckpt_dir: str) -> Dict[str, Any]:
    """Every phase of the dryrun on this rank of N: dp on a (N, 1) mesh; with N even, on a
    (N / 2, 2) mesh :func:`call` with and without head-parallel compute attentions and an
    8-step :func:`sample` of N clouds and the composed :func:`picard_sample`; on the (N, 1) mesh :func:`picard_sample` of 2 clouds
    with the window over ``data`` and :func:`extract` of 2N clouds."""
    import torch.distributed as dist

    dev = _device(device)
    n = dist.get_world_size()
    flat = _mesh(n, 1)
    out: Dict[str, Any] = {"dp": dp_phase(cfg, seed, dev, flat, ckpt_dir)}
    if n % 2 == 0:
        mesh = _mesh(n // 2, 2)
        data = make_inputs(cfg, n, seed)
        model = build_model(cfg, dev, seed, mesh)
        out["call"] = call(model, data, dev, mesh)
        out["call_head"] = call(build_model(cfg, dev, seed, mesh, head=True), data, dev, mesh)
        out["sample"] = sample(model, cfg, data, 8, seed, dev)
        out["composed"] = picard_sample(model, cfg, make_inputs(cfg, 2, seed), 6, 4, 1e-3,
                                        seed, dev, mesh)
    out["picard"] = picard_sample(build_model(cfg, dev, seed), cfg, make_inputs(cfg, 2, seed),
                                  8, window_of(n), 1e-3, seed, dev, flat)
    out["extractor"] = extract(dryrun_clouds(n, seed), 1, seed, dev, flat)
    return out


def dryrun_clouds(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(-0.5, 0.5, (2 * n, 1024, 3)).astype(np.float32)


# ------------------------------------------------------------------ the launcher

def fingerprint(t) -> float:
    return float(torch.as_tensor(np.asarray(t) if not isinstance(t, torch.Tensor) else t)
                 .double().abs().sum())


def rel_l2(a, b) -> float:
    a, b = (torch.as_tensor(np.asarray(v)).double() for v in (a, b))
    return float((a - b).norm() / b.norm())


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="default: gloo on the CPU; on the card NCCL when every rank "
                             "has a card of its own, else gloo")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    from ..core.device import resolve_device

    dev = resolve_device(args.device)
    n = args.ranks
    backend = args.backend
    if dev.type == "cpu":
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError("the CPU takes the gloo backend")
        torch.set_num_threads(1)
    elif backend is None:
        backend = "nccl" if n <= torch.cuda.device_count() else "gloo"
    elif backend == "nccl" and n > torch.cuda.device_count():
        raise ValueError(f"NCCL needs a card a rank: {n} ranks, "
                         f"{torch.cuda.device_count()} cards")
    device = dev.type
    cfg, seed = TINY, args.seed
    head = f"multichip_dryrun(world={n}, {backend} on {device})"
    results: Dict[str, Any] = {"world": n, "backend": backend, "device": device}
    with tempfile.TemporaryDirectory(prefix="pcdiff_dryrun_") as ckpt:
        ranks = run_ranks(dryrun_task, n, backend, device, cfg, seed, device, ckpt)

    # 1. data parallel, with the multi-process checks
    dp = [r["dp"] for r in ranks]
    _, ref = train_step(cfg, train_batch(cfg, 2 * n, seed), seed, dev)
    loss_rel = abs(dp[0]["loss"] - float(ref["loss"])) / abs(float(ref["loss"]))
    _check(all(torch.equal(r["params"], dp[0]["params"]) for r in dp),
           "the ranks' models differ after the averaged step")
    _check(loss_rel <= STEP_REL, f"dp loss {dp[0]['loss']} vs one process {ref['loss']}")
    _check(all(r["hits"].max() <= 1 and int(r["hits"].sum()) == 6 * n for r in dp),
           "the loader's shards overlap or miss rows")
    _check(len(set(dp[0]["folds"].tolist())) == n, "fold_in_process repeats a stream")
    _check(all(r["restored"] and r["restored_step"] == 1 for r in dp),
           "rank 0's checkpoint did not restore on every rank")
    print(f"{head}: mesh ({n}, 1): dp ok, loss {dp[0]['loss']:.6f} (one process: rel "
          f"{loss_rel:.1e}), params fingerprint {fingerprint(dp[0]['params']):.6f}; loader "
          f"shards disjoint, {n} rank streams, checkpoint restored on every rank", flush=True)
    results["dp"] = dict(loss=dp[0]["loss"], loss_rel=loss_rel)

    # 2-3. dp x sp: the points over 'model', the batch over 'data'
    if n % 2 == 0:
        data = make_inputs(cfg, n, seed)
        ref = build_model(cfg, dev, seed, reference=True)
        ref_call, ref_sample = call(ref, data, dev), sample(ref, cfg, data, 8, seed, dev)
        ref_head = call(build_model(cfg, dev, seed, head=True, reference=True), data, dev)
        eps_rel = max(max(rel_l2(r["call"]["eps"], ref_call["eps"]),
                          rel_l2(r["call_head"]["eps"], ref_head["eps"])) for r in ranks)
        _check(eps_rel <= SP_REL_L2, f"dp x sp call rel L2 {eps_rel:.3e} > {SP_REL_L2}")
        print(f"{head}: mesh ({n // 2}, 2): dp x sp ok (read/write sharded over points; and "
              f"head-parallel compute), call rel L2 {eps_rel:.3e}, fingerprint "
              f"{fingerprint(ranks[0]['call']['eps']):.6f}", flush=True)
        cloud_err = max(float((r["sample"]["cloud"] - ref_sample["cloud"]).abs().max())
                        for r in ranks)
        _check(cloud_err <= CLOUD_ATOL, f"sp sample max |err| {cloud_err:.3e}")
        print(f"{head}: mesh ({n // 2}, 2): sp CFG Karras sampling ok (8 heun steps, "
              f"{ranks[0]['sample']['calls']} calls), max |err| {cloud_err:.3e}, fingerprint "
              f"{fingerprint(ranks[0]['sample']['cloud']):.6f}", flush=True)
        results["sp"] = dict(eps_rel=eps_rel, cloud_err=cloud_err)
        # both at once, as tests/test_parallel_sampler.py:177-233 composes them
        dense = sample(ref, cfg, make_inputs(cfg, 2, seed), 6, seed, dev)
        comp_err = max(float((r["composed"]["cloud"] - dense["cloud"]).abs().max())
                       for r in ranks)
        _check(comp_err <= CLOUD_ATOL, f"composed sample max |err| {comp_err:.3e}")
        print(f"{head}: mesh ({n // 2}, 2): Picard window over data x points over model ok "
              f"(6 steps, window 4, tol 1e-3, {ranks[0]['composed']['parallel_iters']} rounds), "
              f"max |err| {comp_err:.3e} against the dense heun, fingerprint "
              f"{fingerprint(ranks[0]['composed']['cloud']):.6f}", flush=True)
        results["composed"] = dict(err=comp_err, iters=ranks[0]["composed"]["parallel_iters"])

    # 4. parallel in time: the window over 'data'
    window = window_of(n)
    ref = picard_sample(build_model(cfg, dev, seed), cfg, make_inputs(cfg, 2, seed), 8,
                        window, 1e-3, seed, dev)
    iters = [r["picard"]["parallel_iters"] for r in ranks]
    x_rel = max(rel_l2(r["picard"]["cloud"], ref["cloud"]) for r in ranks)
    _check(iters == [ref["parallel_iters"]] * n,
           f"Picard rounds {iters} vs one process {ref['parallel_iters']}")
    _check(x_rel <= PICARD_REL, f"heun_parallel rel {x_rel:.3e} > {PICARD_REL}")
    print(f"{head}: mesh ({n}, 1): parallel-in-time Picard sampling ok (window {window} "
          f"over {n} ranks, {iters[0]} rounds as one process), rel {x_rel:.3e}, fingerprint "
          f"{fingerprint(ranks[0]['picard']['cloud']):.6f}", flush=True)
    results["picard"] = dict(iters=iters[0], x_rel=x_rel)

    # the extractor's chunk over 'data'
    clouds = dryrun_clouds(n, seed)
    ref = extract(clouds, 1, seed, dev)
    ext = [r["extractor"] for r in ranks]
    f_rel = max(max(rel_l2(r["features"], ref["features"]), rel_l2(r["preds"], ref["preds"]))
                for r in ext)
    _check(all(torch.equal(r["fps"], ref["fps"]) for r in ext), "FPS indices differ")
    _check(f_rel <= FEATURE_REL, f"extractor rel {f_rel:.3e} > {FEATURE_REL}")
    print(f"{head}: mesh ({n}, 1): P-FID extractor ok ({len(clouds)} clouds, rows over "
          f"{n} ranks, FPS indices equal), rel {f_rel:.3e}, fingerprint "
          f"{fingerprint(ext[0]['features']):.6f}", flush=True)
    results["extractor"] = dict(rel=f_rel)
    print(f"{head}: all phases ok", flush=True)
    return results


if __name__ == "__main__":
    main()
