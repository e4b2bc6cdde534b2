"""The port's trained-quality scripts (``pcdiff_torch/scripts/trained_gates.py`` and
``shapes_evidence.py``) against the JAX package's (CPU).

The gate registry and the row format equal ``scripts/trained_gates.py``'s; the
copy-the-partial baseline on the held-out shapes fixture (seed 9, 4 instances a class, 120
scans) equals the JAX package's ``CompletionMetrics`` over the same clamped partials; and
both scripts run end to end on the CPU on one tiny run (1 instance a class, 2 training
steps, 2 Karras steps, narrow widths), whose rows are written one at a time, resumed
without scoring twice, with the EMA row recorded as skipped and ``bf16-gi-reuse-scan``
equal to ``bf16-gi-reuse``.
"""

import glob
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from pcdiff.evals import CompletionMetrics as JaxCompletionMetrics
from pcdiff_torch.cli import evaluate as cli_evaluate
from pcdiff_torch.core.config import load_config
from pcdiff_torch.data import BatchLoader, ModelNetCompletion
from pcdiff_torch.scripts import shapes_evidence as tse
from pcdiff_torch.scripts import trained_gates as ttg

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_gates():
    spec = importlib.util.spec_from_file_location(
        "jax_trained_gates", os.path.join(REPO, "scripts", "trained_gates.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_GATES = _load_jax_gates()

# the JAX package's partial-copy baseline on this fixture, computed on the CPU; the
# committed TPU record (docs/shapes_evidence.json) reads CD 0.012036 and F1 0.710821, 1.8%
# and 0.022 away on a computation without randomness
JAX_CPU_PARTIAL_COPY = (0.0118238, 0.7330016)
PARTIAL_COPY_RTOL = 1e-5

# a narrow model: the ends of the scripts at CPU speed, not their quality
TINY = ["model.latent_dim=32", "model.x_dim=32", "model.num_blocks=1",
        "model.num_compute_layers=1", "model.num_heads=2", "model.num_latents=8",
        "model.active_modalities=[class,view]", "sample.karras_steps=2",
        "sample.num_samples=32", "train.epochs=2", "train.save_every=2"]
ROWS = ("baseline", "bf16", "picard-1e-3", "bf16-gi-reuse", "bf16-gi-reuse-scan",
        "ema-baseline")


@pytest.mark.parametrize("i", range(len(JAX_GATES.GATES)))
def test_gate_registry_equals_the_jax_scripts(i):
    """Names, overrides (decimal literals as written), EMA flags and order."""
    assert len(ttg.GATES) == len(JAX_GATES.GATES)
    assert tuple(ttg.GATES[i]) == tuple(JAX_GATES.GATES[i])


@pytest.mark.parametrize("run_dir", ["/runs/run_19-08-2026_18-49", "/runs/run_19-08-2026_18-49/"])
def test_make_gate_row_equals_the_jax_scripts(run_dir):
    summary = {
        "overall": {"cd_full": 0.0037935, "f1_full": 0.4649, "cd_fps": 0.0037935, "count": 48},
        "per_class": {
            "airplane": {"cd_full": 0.0028, "f1_full": 0.57, "count": 24},
            "car": {"cd_full": 0.0070, "f1_full": 0.21, "count": 24},
        },
    }
    overrides = ["sample.sampler=heun_parallel", "sample.parallel_tol=0.001"]
    want = JAX_GATES.make_gate_row(summary, list(overrides), run_dir)
    assert ttg.make_gate_row(summary, list(overrides), run_dir) == want
    assert want["checkpoint"] == "run_19-08-2026_18-49"


def test_gate_overrides_parse_as_the_jax_configs_do():
    """The port's override reader takes every row's strings as the JAX loader takes them:
    the tolerances as floats, the scan flag as a bool."""
    from pcdiff.core.config import load_config as jax_load

    config = os.path.join(REPO, "configs", "synthetic_shapes.yaml")
    for row in ttg.GATES:
        mine, theirs = load_config(config, row[1]), jax_load(config, list(row[1]))
        for section in ("model", "sample"):
            for key, value in vars(getattr(theirs, section)).items():
                got = getattr(getattr(mine, section), key)
                assert (tuple(got) if isinstance(got, (list, tuple)) else got) == \
                    (tuple(value) if isinstance(value, (list, tuple)) else value), \
                    (row[0], section, key)
    assert isinstance(load_config(config, ["sample.parallel_tol=0.001"]).sample.parallel_tol,
                      float)


def test_partial_copy_equals_the_jax_metrics(tmp_path):
    """The port's baseline on the held-out fixture against the JAX package's
    ``CompletionMetrics`` over the same clamped partials, in the same batches."""
    test_data = tse.make_fixture(str(tmp_path), "test", tse.INSTANCES[1])
    cfg = load_config(tse.CONFIG, [f"data.h5_path={test_data}"])
    mine = tse.partial_copy_baseline(cfg, test_data, "cpu")

    dataset = ModelNetCompletion(test_data, split="test")
    jax_metrics = JaxCompletionMetrics(fps_points=1024)
    for batch in BatchLoader(dataset, cfg.sample.num_samples, shuffle=False,
                             seed=cfg.train.seed, drop_last=False):
        jax_metrics.update(np.clip(batch["partial_pcd"], -0.5, 0.5), batch["target"],
                           batch["class_labels"])
    names = {v: k for k, v in dataset.class_to_label.items()}
    dataset.close()
    want = jax_metrics.summary(class_names=names)

    assert mine["overall"]["count"] == want["overall"]["count"] == 120
    for got, ref in [(mine["overall"], want["overall"])] + [
            (mine["per_class"][c], want["per_class"][c]) for c in want["per_class"]]:
        for key in ("cd_full", "f1_full"):
            np.testing.assert_allclose(got[key], ref[key], rtol=PARTIAL_COPY_RTOL, atol=0)
    # to the seven decimals quoted
    np.testing.assert_allclose([want["overall"]["cd_full"], want["overall"]["f1_full"]],
                               JAX_CPU_PARTIAL_COPY, rtol=0, atol=5e-8)


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """Both scripts on the CPU: shapes_evidence trains and scores, then trained_gates scores
    ``ROWS`` on the run's own config, and again with ``skip_done``. Records the rows in the
    record after each write and every evaluation's checkpoint."""
    work = str(tmp_path_factory.mktemp("shapes"))
    evidence = tse.run(None, TINY, work=work, seeds=(1,), instances=(1, 1), device="cpu")
    run_dir, = glob.glob(os.path.join(work, "runs", "run_*"))
    config = os.path.join(run_dir, "config_used.yaml")
    dest = os.path.join(work, "gates", "trained_gates.json")
    writes, evaluated = [], []
    write, evaluate = ttg._write, cli_evaluate.main

    def record_write(path, results):
        writes.append(list(results))
        write(path, results)

    def record_evaluate(cfg, device="cuda"):
        evaluated.append((cfg.model.compute_dtype, cfg.sample.sampler))
        return evaluate(cfg, device=device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttg, "_write", record_write)
        mp.setattr(cli_evaluate, "main", record_evaluate)
        first = ttg.main(run_dir, config, only=ROWS, dest=dest, device="cpu")
        n_first = len(evaluated)
        second = ttg.main(run_dir, config, only=ROWS, dest=dest, skip_done=True, device="cpu")
    with open(dest) as f:
        on_disk = json.load(f)
    return dict(evidence=evidence, first=first, second=second, on_disk=on_disk,
                writes=writes, n_first=n_first, n_all=len(evaluated), dest=dest,
                run_dir=run_dir)


def test_rows_are_written_one_at_a_time(tiny_run):
    assert list(tiny_run["first"]) == list(ROWS)
    # one write a row, each holding the rows before it, then the final write
    assert tiny_run["writes"][:len(ROWS)] == [list(ROWS[:i + 1]) for i in range(len(ROWS))]
    assert tiny_run["on_disk"] == json.loads(json.dumps(tiny_run["second"]))
    assert not glob.glob(os.path.join(os.path.dirname(tiny_run["dest"]), "evaluation_log_*"))


def test_skip_done_scores_nothing_twice(tiny_run):
    assert tiny_run["n_first"] == len(ROWS) - 1  # the EMA row has no shadow to score
    assert tiny_run["n_all"] == tiny_run["n_first"]
    assert tiny_run["second"] == tiny_run["first"]


def test_ema_row_is_recorded_as_skipped(tiny_run):
    row = tiny_run["first"]["ema-baseline"]
    assert "ema" in row["skipped"] and row["ema_params"] is True
    assert "cd_full" not in row
    assert not os.path.isdir(os.path.join(tiny_run["run_dir"], "ema"))


@pytest.mark.parametrize("key", ["cd_full", "f1_full", "per_class"])
def test_scan_row_equals_bf16_gi_reuse(tiny_run, key):
    """``model.scan_blocks`` has no effect in the port: the same program, the same row."""
    rows = tiny_run["first"]
    assert rows["bf16-gi-reuse-scan"][key] == rows["bf16-gi-reuse"][key]


def test_baseline_row_equals_the_trained_heldout_row(tiny_run):
    """The gate harness's baseline is shapes_evidence's trained row: the same program and
    sampling seed."""
    rows, evidence = tiny_run["first"], tiny_run["evidence"]
    assert rows["baseline"]["cd_full"] == evidence["trained_heldout"]["overall"]["cd_full"]
    assert rows["baseline"]["f1_full"] == evidence["trained_heldout"]["overall"]["f1_full"]
    assert rows["bf16"]["cd_full"] != rows["baseline"]["cd_full"]


def test_evidence_record(tiny_run, tmp_path):
    ev = tiny_run["evidence"]
    assert set(ev) == {"trained_heldout", "untrained", "partial_copy", "sampling_seeds", "run"}
    for key in ("trained_heldout", "untrained", "partial_copy"):
        assert ev[key]["overall"]["count"] == 30 and len(ev[key]["per_class"]) == 5
    # a sampling seed other than the config's samples other clouds from the same weights
    assert set(ev["sampling_seeds"]) == {"42", "1"}
    assert ev["sampling_seeds"]["42"] == ev["trained_heldout"]
    assert ev["sampling_seeds"]["1"]["overall"] != ev["trained_heldout"]["overall"]
    run = ev["run"]
    assert run["card"] == "cpu" and run["steps"] == 2 and run["overrides"] == TINY
    assert set(run["evaluate_s"]) == {"trained_heldout", "untrained", "partial_copy", "seed 1"}
    work = os.path.dirname(os.path.dirname(tiny_run["run_dir"]))
    with open(os.path.join(work, "shapes_evidence.json")) as f:
        assert json.load(f) == json.loads(json.dumps(ev))
    assert os.path.exists(os.path.join(work, "evaluation_log_shapes_untrained.txt"))


@pytest.mark.parametrize("script", ["trained_gates", "shapes_evidence"])
def test_scripts_run_on_the_card_by_default(tmp_path, script):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    with pytest.raises(RuntimeError, match="CUDA card"):
        if script == "trained_gates":
            ttg.main(str(tmp_path / "runs" / "run_x"))
        else:
            tse.main(["--work", str(tmp_path)])


def test_graph_counters_take_back_a_capture_and_add_each_replay():
    """``train.graphs`` keeps the kernel counters true: a capture's wrapper calls are taken
    back, a replay adds them (the dict counters by width too)."""
    from pcdiff_torch.ops import ln_dense
    from pcdiff_torch.train import graphs

    before = graphs._read_counters()
    ln_dense.launches += 5
    ln_dense.width_launches[128] = ln_dense.width_launches.get(128, 0) + 5
    delta = graphs._diff_counters(graphs._read_counters(), before)
    assert delta[("pcdiff_torch.ops.ln_dense", "launches")] == 5
    assert delta[("pcdiff_torch.ops.ln_dense", "width_launches")] == {128: 5}
    graphs._add_counters(delta, -1)
    assert graphs._read_counters() == before
    graphs._add_counters(delta)
    graphs._add_counters(delta, -1)
    assert graphs._read_counters() == before


def test_cuda_graphs_leave_a_cpu_step_eager():
    """On the CPU ``cuda_graphs`` changes nothing: the same update, bit for bit."""
    from pcdiff_torch.core import init_params
    from pcdiff_torch.diffusion import diffusion_from_betas
    from pcdiff_torch.models import TwoStreamDenoiser
    from pcdiff_torch.train import create_train_state, make_train_step

    batch = {"target": np.random.default_rng(0).uniform(-0.5, 0.5, (2, 16, 3)).astype(np.float32),
             "class_labels": np.array([1, 2])}
    params = []
    for graphs in (False, True):
        g = torch.Generator().manual_seed(0)
        m = init_params(TwoStreamDenoiser(num_points=16, num_latents=4, latent_dim=32, x_dim=32,
                                          num_blocks=1, num_compute_layers=1, num_heads=4,
                                          active_modalities=("class",), device="cpu"), g)
        state = create_train_state(m, total_steps=10, device="cpu")
        step = make_train_step(m, diffusion_from_betas(), self_conditioning_prob=0.5,
                               device="cpu", cuda_graphs=graphs)
        for use_cd in (False, True, True):
            step(state, batch, g, use_cd)
        params.append([p.detach().clone() for p in m.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*params))
