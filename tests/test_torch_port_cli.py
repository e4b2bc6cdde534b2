"""The port's drivers on the CPU at a tiny size: train (device data on and off), resume,
sample and evaluate through ``pcdiff_torch.cli``; a resumed run equals an unbroken one bit
for bit; and the driver path on ``.npz`` data imports none of jax, pcdiff, yaml or h5py."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pcdiff_torch.cli import evaluate as cli_evaluate
from pcdiff_torch.cli import sample as cli_sample
from pcdiff_torch.cli import train as cli_train
from pcdiff_torch.core.checkpoint import export_two_stream_torch_state
from pcdiff_torch.core.config import load_config
from pcdiff_torch.data import BatchLoader, ModelNetCompletion, make_modelnet_fixture
from pcdiff_torch.geometry import read_ply
from pcdiff_torch.models.wrapper import BoundTwoStream
from pcdiff_torch.train import make_device_data_step, permute_points

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]

TINY = [
    "model.num_points=64", "model.num_latents=8", "model.latent_dim=32", "model.x_dim=32",
    "model.num_blocks=1", "model.num_compute_layers=1", "model.num_heads=4",
    "model.num_tokens_ppcd=4", "model.num_tokens_depth=4", "model.depth_image_size=64",
    "model.depth_patch=16", "diffusion.timesteps=50", "sample.karras_steps=2",
    "sample.num_samples=12", "sample.sigma_max=20", "train.batch_size=8",
    "train.start_chamfer=1", "train.save_every=1", "train.sample_every=2",
    "train.ema_decay=0.9",
]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("drivers")
    return root, make_modelnet_fixture(str(root / "synth.npz"))  # 30 scans: 3 steps an epoch


def _cfg(data, *overrides):
    return load_config(None, TINY + [f"data.h5_path={data}", *overrides])


def _losses(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [(r["step"], r["loss"], r["mse"]) for r in map(json.loads, f)]


@pytest.fixture(scope="module", params=["on", "off"])
def unbroken(request, fixture):
    root, data = fixture
    run = cli_train.main(_cfg(data, f"train.output_dir={root}/full_{request.param}",
                              "train.epochs=2", f"train.device_data={request.param}"),
                         device="cpu")
    return request.param, run


def test_train_writes_metrics_checkpoints_and_samples(unbroken):
    mode, run = unbroken
    assert run["device_data"] == (mode == "on")
    log = _losses(run["run_dir"])
    assert [s for s, _, _ in log] == list(range(1, 7))
    assert all(np.isfinite(v) for _, loss, mse in log for v in (loss, mse))
    assert all(loss > mse for _, loss, mse in log[3:])  # the chamfer term from epoch 2
    for sub in ("checkpoints", "ema"):
        assert sorted(os.listdir(os.path.join(run["run_dir"], sub))) == ["3", "6"]
    for sub in ("samples_epoch_2", "target_points_epoch_2", "partial_pcd_epoch_2"):
        assert len(os.listdir(os.path.join(run["run_dir"], sub))) == 8
    assert os.path.isfile(os.path.join(run["run_dir"], "config_used.yaml"))
    assert load_config(os.path.join(run["run_dir"], "config_used.yaml")).model.num_points == 64


def test_resume_equals_the_unbroken_run(unbroken, fixture, tmp_path):
    mode, full = unbroken
    _, data = fixture
    # a run that stopped after epoch 1: only the step-3 checkpoint and EMA exist
    for sub in ("checkpoints", "ema"):
        shutil.copytree(os.path.join(full["run_dir"], sub, "3"), tmp_path / "died" / sub / "3")
    run = cli_train.main(_cfg(data, f"train.output_dir={tmp_path}/resumed", "train.epochs=2",
                              f"train.device_data={mode}", "train.continue_training=true",
                              f"train.load_checkpoint_path={tmp_path}/died/checkpoints"),
                         device="cpu")
    assert run["resumed_step"] == 3 and run["global_step"] == 6
    assert _losses(run["run_dir"]) == _losses(full["run_dir"])[3:]
    for p, q in zip(run["state"].params, full["state"].params, strict=True):
        assert torch.equal(p, q)
    assert run["state"].step == full["state"].step == 6
    assert all(torch.equal(run["ema"][k], v) for k, v in full["ema"].items())


def test_sample_and_evaluate(unbroken, fixture, tmp_path, monkeypatch):
    mode, full = unbroken
    _, data = fixture
    monkeypatch.chdir(tmp_path)  # the evaluation log goes to the working directory
    ckpt = os.path.join(full["run_dir"], "ema" if mode == "on" else "checkpoints")
    cfg = _cfg(data, f"sample.load_checkpoint_path={ckpt}", f"sample.output_dir={tmp_path}/s")
    out = cli_sample.main(cfg, device="cpu")
    for sub, prefix, arrays in (("targets", "target", out["targets"]),
                                ("partials", "partial", out["partials"]),
                                ("samples", "sample", out["samples"])):
        assert len(arrays) == 12
        for i, arr in enumerate(arrays):
            with open(os.path.join(out["dir"], sub, f"{prefix}_{i + 1}.ply"), "rb") as f:
                assert np.array_equal(read_ply(f)["coords"], np.asarray(arr, np.float32))
    summary = cli_evaluate.main(cfg, device="cpu")
    assert summary["overall"]["count"] == 30  # 12 + 12 + a ragged 6
    assert set(summary["per_class"]) == {"airplane", "bench", "bottle", "car", "monitor"}
    assert all(np.isfinite(r["cd_full"]) and 0.0 <= r["f1_full"] <= 1.0
               for r in [summary["overall"], *summary["per_class"].values()])
    logs = list(tmp_path.glob("evaluation_log_*.txt"))
    assert len(logs) == 1 and "attention=kernel" in logs[0].read_text()


@pytest.mark.parametrize("sampler", ["heun_parallel", "dpm", "ancestral"])
def test_configured_samplers_run(fixture, sampler):
    """Each solver beyond heun and heun_reuse, built from the config (heun_parallel with its
    window and tolerance) and sampled on the CPU, with the denoiser calls it implies."""
    _, data = fixture
    cfg = _cfg(data, f"sample.sampler={sampler}", "sample.parallel_window=2",
               "sample.parallel_tol=0.0")
    model = cli_train.init_params(cli_train.build_model(cfg, "cpu"), cfg,
                                  torch.Generator().manual_seed(0))
    bound = BoundTwoStream(model.eval())
    sampler_ = cli_sample.build_sampler(cfg, bound)
    assert sampler_.sampler == sampler
    assert sampler_.parallel_options == {"window": 2, "tol": 0.0}
    dataset = ModelNetCompletion(data, split="test")
    batch = next(iter(BatchLoader(dataset, 2, shuffle=False, seed=0, prefetch=0)))
    out = sampler_.sample_batch(2, cli_sample.batch_kwargs(batch, "cpu"),
                                torch.Generator().manual_seed(1))
    dataset.close()
    assert out.shape == (2, 64, 3) and torch.isfinite(out).all()
    steps = cfg.sample.karras_steps
    calls = {"dpm": 2 * steps, "ancestral": steps,
             "heun_parallel": 2 * sum(sampler_.parallel_iters)}[sampler]
    assert bound.calls == calls
    if sampler == "heun_parallel":
        assert 1 <= sampler_.parallel_iters[0] <= steps


def test_reference_pt_as_initial_weights(fixture, tmp_path):
    _, data = fixture
    cfg = _cfg(data, "train.epochs=0", f"train.output_dir={tmp_path}/a")
    model = cli_train.init_params(cli_train.build_model(cfg, "cpu"), cfg,
                                  torch.Generator().manual_seed(7))
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_two_stream_torch_state(model).items()}
    torch.save(sd, tmp_path / "ref.pt")
    run = cli_train.main(_cfg(data, "train.epochs=0", f"train.output_dir={tmp_path}/b",
                              "train.continue_training=true",
                              f"train.load_checkpoint_path={tmp_path}/ref.pt"), device="cpu")
    want = dict(model.named_parameters())
    assert all(torch.equal(p, want[n]) for n, p in run["state"].model.named_parameters())


def test_device_data_step_permutes_targets():
    target = torch.arange(2 * 50 * 3, dtype=torch.float32).reshape(2, 50, 3)
    a = permute_points(target, torch.Generator().manual_seed(0))
    b = permute_points(target, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and not torch.equal(a, target)
    for row, orig in zip(a, target):  # each sample's own points, whole rows kept
        assert torch.equal(row[row[:, 0].argsort()], orig)
    assert callable(make_device_data_step)


def test_entry_points_default_to_the_card(fixture):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable here")
    _, data = fixture
    for cli in (cli_train, cli_sample, cli_evaluate):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(_cfg(data))


DRIVERS = r"""
import os, sys
from pcdiff_torch.cli import evaluate, sample, train
from pcdiff_torch.data import make_shapes_fixture
root = sys.argv[1]
data = make_shapes_fixture(os.path.join(root, "shapes.npz"), instances_per_class=1,
                           scans_per_instance=4, num_points=64, depth_size=64)
tiny = sys.argv[2:] + [f"data.h5_path={data}", f"train.output_dir={root}/runs",
                       "train.epochs=1", "train.batch_size=4"]
train.cli(["--device", "cpu", *tiny])
run = os.path.join(root, "runs", os.listdir(os.path.join(root, "runs"))[0])
ckpt = [f"sample.load_checkpoint_path={run}/checkpoints", f"sample.output_dir={root}/s",
        "sample.num_samples=8"]
sample.cli(["--device", "cpu", *tiny, *ckpt])
os.chdir(root)
evaluate.cli(["--device", "cpu", *tiny, *ckpt])
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "pcdiff", "yaml", "h5py"))
assert not bad, bad
print("ok")
"""


def test_npz_driver_path_imports_no_jax_pcdiff_yaml_or_h5py(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    overrides = [o for o in TINY if not o.startswith(("train.sample_every", "train.batch_size"))]
    proc = subprocess.run([sys.executable, "-c", DRIVERS, str(tmp_path), *overrides],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
    assert list((tmp_path / "s" / "batch_0000" / "samples").glob("*.ply"))
