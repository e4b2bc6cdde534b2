"""The port's data parallelism on the CPU (gloo): a 2-rank train step against a 1-process
step on the same global batch, the train driver on two ranks (MVP data), the loader's
shards, the host-side mean, and a world of one; and the driver on the multimodal data.

The two ranks run in processes of their own, started by ``torch.multiprocessing`` and
joined through a ``FileStore`` in ``tmp_path``. Each holds the tiny denoiser with the same
seeded weights and half of a global batch of 4; the 1-process step takes the whole batch.
Dropout and CFG dropout are on (train mode): the ranks draw the global batch's masks from
generators seeded alike and keep their rows. The loss, ``grad_norm`` and the updated
parameters must agree within rel 1e-6 (the gradients' sums run in another order: the
all-reduce adds two half-batch means where the one process sums the whole batch);
the parameters are compared as one vector, since a key bias's gradient is zero in exact
arithmetic and its AdamW update follows the rounding noise.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from pcdiff_torch.cli import train as cli_train
from pcdiff_torch.core import init_params
from pcdiff_torch.core.config import load_config
from pcdiff_torch.data import (
    BatchLoader,
    make_multimodal_fixture,
    make_mvp_fixture,
    synthetic_batch,
)
from pcdiff_torch.diffusion import diffusion_from_betas
from pcdiff_torch.models import TwoStreamDenoiser
from pcdiff_torch.parallel import (
    fold_in_process,
    host_mean,
    initialize,
    is_lead_host,
    local_batch_slice,
    make_mesh,
    replicate,
    shard_batch,
)
from pcdiff_torch.parallel.distributed import process_count, process_index
from pcdiff_torch.parallel.mesh import data_group
from pcdiff_torch.train import create_train_state, make_device_data_step, make_train_step

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores

TINY = dict(num_points=32, num_latents=8, latent_dim=32, x_dim=32, num_blocks=1,
            num_compute_layers=1, num_heads=4, num_classes=10, num_tokens_ppcd=4,
            num_tokens_depth=4, depth_image_size=32, depth_patch=16, cond_drop_prob=0.1)
GLOBAL_B = 4
WORLD = 2
REL = 1e-6
# the drivers' tiny model (tests/test_torch_port_cli.py's), 2 epochs, a sample and a save
# each epoch
DRIVER = [
    "model.num_points=64", "model.num_latents=8", "model.latent_dim=32", "model.x_dim=32",
    "model.num_blocks=1", "model.num_compute_layers=1", "model.num_heads=4",
    "model.num_tokens_ppcd=4", "model.num_tokens_depth=4", "model.depth_image_size=64",
    "model.depth_patch=16", "diffusion.timesteps=50", "sample.karras_steps=2",
    "sample.sigma_max=20", "train.batch_size=8", "train.epochs=2", "train.save_every=1",
    "train.sample_every=1", "train.ema_decay=0.9",
]
# MVP: labels 1-16, so 17 classes; no view and no depth map
MVP = ["data.dataset=mvp", "model.num_classes=17", "model.active_modalities=[class,partial_pcd]"]


def _batch():
    return synthetic_batch(np.random.default_rng(11), GLOBAL_B, 32, 8, 32)


@functools.lru_cache(maxsize=1)
def _one_process():
    return _steps(None)


def _steps(group):
    """One train step and one device-data step of a fresh tiny model on this process's
    share of the global batch: (loss, grad_norm, flat parameters) of each."""
    torch.manual_seed(0)
    out = []
    for kind in ("batch", "device_data"):
        model = init_params(TwoStreamDenoiser(**TINY, device="cpu"),
                            torch.Generator().manual_seed(1))
        state = create_train_state(model, lr=1e-3, total_steps=10, grad_clip=1.0,
                                   device="cpu")
        diffusion = diffusion_from_betas("linear", 100)
        gen = torch.Generator().manual_seed(5)
        if kind == "batch":
            step = make_train_step(model, diffusion, self_conditioning_prob=1.0,
                                   data_group=group, device="cpu")
            batch = _batch()
            if group is not None:
                batch = shard_batch(make_mesh(), batch)
            m = step(state, batch, gen, True)
        else:
            step = make_device_data_step(model, diffusion, self_conditioning_prob=1.0,
                                         data_group=group, device="cpu")
            data = {k: torch.from_numpy(v) for k, v in _batch().items()}
            idx = np.array([3, 0, 2, 1])
            if group is not None:
                idx = idx[local_batch_slice(GLOBAL_B)]
            m = step(state, data, idx, gen, True)
        flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
        out.append((m["loss"].item(), m["grad_norm"].item(), flat))
    return out


def _driver(data, out, *overrides):
    return cli_train.main(load_config(None, DRIVER + [f"data.h5_path={data}",
                                                      f"train.output_dir={out}",
                                                      *overrides]), device="cpu")


def _rank_main(rank, store_path, out_dir):
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, WORLD)
    initialize(world_size=WORLD, rank=rank, device="cpu", store=store)
    try:
        mesh = make_mesh()
        res = dict(rank=process_index(), world=process_count(), lead=is_lead_host(),
                   mean=host_mean(float(rank + 1)),
                   slice=local_batch_slice(8),
                   fold=torch.rand((), generator=fold_in_process(3)).item())
        t = torch.full((3,), float(rank))
        replicate(mesh, t)
        res["replicated"] = t.tolist()
        res["steps"] = _steps(data_group(mesh))
        run = _driver(os.path.join(out_dir, "mvp.npz"), os.path.join(out_dir, "run"), *MVP)
        res["driver"] = {k: run[k] for k in ("run_dir", "rank", "world", "global_step",
                                             "epochs", "device_data")}
        res["driver"]["params"] = [p.detach().clone() for p in run["state"].params]
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gloo")
    make_mvp_fixture(str(tmp / "mvp.npz"), num_points=128)  # 52 scans: 26 a rank
    mp.start_processes(_rank_main, args=(str(tmp / "store"), str(tmp)), nprocs=WORLD,
                       join=True, start_method="spawn")
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("kind", [0, 1], ids=["train_step", "device_data_step"])
def test_two_ranks_match_one_process_on_the_global_batch(ranks, kind):
    loss, gnorm, flat = _one_process()[kind]
    for res in ranks:
        r_loss, r_gnorm, r_flat = res["steps"][kind]
        assert _rel(r_loss, loss) <= REL, (r_loss, loss)
        assert _rel(r_gnorm, gnorm) <= REL, (r_gnorm, gnorm)
        assert ((r_flat - flat).norm() / flat.norm()).item() <= REL
    # the ranks hold one model: bit-equal after the averaged update
    assert torch.equal(ranks[0]["steps"][kind][2], ranks[1]["steps"][kind][2])


def test_driver_trains_mvp_on_two_ranks(ranks):
    """Each rank trains its 26 scans (3 steps of 8 an epoch, device-resident), the
    gradients averaged: one model on both ranks, bit for bit; rank 0 alone writes."""
    runs = [r["driver"] for r in ranks]
    assert [r["rank"] for r in runs] == [0, 1] and all(r["world"] == WORLD for r in runs)
    assert runs[0]["run_dir"] == runs[1]["run_dir"]
    assert all(r["global_step"] == 6 and r["device_data"] for r in runs)
    assert [e["loss"] for e in runs[0]["epochs"]] == [e["loss"] for e in runs[1]["epochs"]]
    assert all(torch.equal(a, b) for a, b in zip(runs[0]["params"], runs[1]["params"]))
    run_dir = runs[0]["run_dir"]
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert [r["step"] for r in log] == list(range(1, 7))
    assert all(np.isfinite(r["loss"]) for r in log)
    assert sorted(os.listdir(os.path.join(run_dir, "checkpoints"))) == ["3", "6"]
    assert len(os.listdir(os.path.join(run_dir, "samples_epoch_2"))) == 8
    assert os.listdir(os.path.dirname(run_dir)) == [os.path.basename(run_dir)]


def test_driver_trains_multimodal(tmp_path):
    data = make_multimodal_fixture(str(tmp_path / "mm.npz"), num_scans=154, num_points=64,
                                   depth_size=64)  # 2 objects x 40 scans: 10 steps an epoch
    run = _driver(data, tmp_path / "run", "data.dataset=multimodal", "train.epochs=1",
                  "train.sample_every=2")
    assert run["world"] == 1 and run["global_step"] == 10
    assert np.isfinite(run["epochs"][0]["loss"])
    assert os.listdir(os.path.join(run["run_dir"], "checkpoints")) == ["10"]


def test_process_identity_host_mean_and_replicate(ranks):
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["world"] == WORLD for r in ranks)
    assert [r["lead"] for r in ranks] == [True, False]
    assert all(r["mean"] == 1.5 for r in ranks)
    assert [r["slice"] for r in ranks] == [slice(0, 4), slice(4, 8)]
    assert ranks[0]["fold"] != ranks[1]["fold"]
    assert all(r["replicated"] == [0.0] * 3 for r in ranks)


def test_loader_shards_are_disjoint_and_cover_the_permutation():
    class Items:
        def __len__(self):
            return 50

        def __getitem__(self, i, rng=None):
            return {"i": np.int64(i)}

    for epoch in (0, 3):
        shards = []
        for rank in range(3):
            loader = BatchLoader(Items(), 4, seed=2, process_index=rank, process_count=3,
                                 prefetch=0)
            loader.set_epoch(epoch)
            rows = loader.epoch_indices().ravel()
            assert list(rows) == [int(i) for b in loader for i in b["i"]]
            shards.append(set(rows.tolist()))
        assert all(not (a & b) for i, a in enumerate(shards) for b in shards[i + 1:])
        assert len(set().union(*shards)) == 3 * 4 * (50 // 3 // 4)


def test_a_world_of_one_is_a_no_op():
    initialize(world_size=1, device="cpu")
    assert not dist.is_initialized()
    assert make_mesh() is None and data_group(None) is None
    assert (process_index(), process_count(), is_lead_host()) == (0, 1, True)
    assert host_mean(2.5) == 2.5
    batch = {"x": np.arange(4)}
    assert shard_batch(None, batch) is batch
    t = torch.ones(2)
    assert replicate(None, t) is t
    assert local_batch_slice(6) == slice(0, 6)
    a, b = fold_in_process(9), torch.Generator().manual_seed(9)
    assert torch.equal(torch.rand(3, generator=a), torch.rand(3, generator=b))
