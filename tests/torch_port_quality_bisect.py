"""Bisect a gap between the port's and the JAX package's trained quality on
``configs/synthetic_quality.yaml`` (run by hand on the CPU; pytest collects nothing here).

    JAX_PLATFORMS=cpu python -m tests.torch_port_quality_bisect schedules
    JAX_PLATFORMS=cpu python -m tests.torch_port_quality_bisect score WEIGHTS.pt {jax|torch} SEED
    JAX_PLATFORMS=cpu python -m tests.torch_port_quality_bisect train-jax SEED OUT_DIR
    python -m tests.torch_port_quality_bisect chance

- ``schedules``: both train drivers run on the config with their step replaced by a
  recorder; prints what each uses (steps, the lr at steps 0, 1, 100 and 1999, the step the
  chamfer term starts, AdamW's settings, the coin, CFG dropout, the EMA decay, each step's
  index row, the stacked data) and whether the two agree.
- ``score``: the port's weights (a ``state_dict`` saved with ``torch.save``) sampled with 64
  Karras steps and CFG 3 and scored over the config's 80 scans by one package's
  ``cli.evaluate`` (the JAX package gets them through ``flax_from_params``), sampling seed
  ``SEED``.
- ``train-jax``: the JAX package's ``cli.train`` at ``train.seed=SEED`` into ``OUT_DIR``, its
  final parameters saved as ``OUT_DIR/weights.pt`` for ``score`` (through
  ``params_from_flax``), the seconds printed.
- ``chance``: CD and F1 of uniform random clouds against random targets, as the fixture's.

The fixture is written under ``OUT_DIR`` (``score``: beside the weights) by each package's
own builder at seed 7, as ``scripts/make_quality_fixture.py`` and
``pcdiff_torch.scripts.quality`` write it.
"""

import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "synthetic_quality.yaml")
FIXTURE = dict(instances_per_class=4, scans_per_instance=4, num_points=256, depth_size=64,
               seed=7)


def _jax_cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")


def _fixtures(work):
    from pcdiff.data import make_modelnet_fixture as jax_fixture
    from pcdiff_torch.data import make_modelnet_fixture as torch_fixture

    h5, npz = os.path.join(work, "q.h5"), os.path.join(work, "q.npz")
    if not os.path.exists(h5):
        jax_fixture(h5, **FIXTURE)
    if not os.path.exists(npz):
        torch_fixture(npz, **FIXTURE)
    return h5, npz


def schedules(work):
    import jax.numpy as jnp
    import optax
    import torch

    import pcdiff.cli.train as jt
    import pcdiff.train.state as jstate
    import pcdiff_torch.cli.train as tt
    import pcdiff_torch.train as ttrain
    from pcdiff.core.config import load_config as jax_config
    from pcdiff_torch.core.config import load_config as torch_config

    h5, npz = _fixtures(work)
    rec = {"jax": {"steps": []}, "torch": {"steps": []}}
    probe = (0, 1, 100, 1999)

    J = rec["jax"]
    cosine = jstate.cosine_annealing_schedule

    def jax_schedule(peak, total, eta_min=1e-6):
        s = cosine(peak, total, eta_min)
        J.update(total_steps=total, lr=[float(s(k)) for k in probe])
        return s

    adamw = optax.adamw

    def jax_adamw(**kw):
        J["adamw"] = [kw.get("b1"), kw.get("b2"), kw.get("eps", 1e-8), kw.get("weight_decay")]
        return adamw(**kw)

    create = jt.create_train_state

    def jax_create(model, params, **kw):
        J["cond_drop_prob"] = model.cond_drop_prob
        return create(model, params, **kw)

    def jax_step(model, diffusion, **kw):
        J["coin"] = kw["self_conditioning_prob"]

        def step(state, data, idx, key, use_cd):
            J.setdefault("data", {k: np.asarray(v) for k, v in data.items()})
            J["steps"].append((np.asarray(idx).tolist(), bool(use_cd)))
            return state, {"loss": jnp.float32(0), "mse": jnp.float32(0)}
        return step

    jstate.cosine_annealing_schedule, optax.adamw = jax_schedule, jax_adamw
    jt.create_train_state, jt.make_device_data_step = jax_create, jax_step
    jt.save_checkpoint = lambda *a, **k: None
    cfg = jax_config(CONFIG, [f"data.h5_path={h5}", f"train.output_dir={work}/jax_runs"])
    J["ema_decay"] = cfg.train.ema_decay
    jt.main(cfg)

    T = rec["torch"]
    create_t = ttrain.create_train_state

    def torch_create(model, **kw):
        st = create_t(model, **kw)
        d = st.optimizer.defaults
        T.update(total_steps=kw["total_steps"], lr=[float(st.schedule(k)) for k in probe],
                 adamw=[d["betas"][0], d["betas"][1], d["eps"], d["weight_decay"]],
                 cond_drop_prob=model.cond_drop_prob)
        return st

    def torch_step(model, diffusion, **kw):
        T["coin"] = kw["self_conditioning_prob"]

        def step(state, data, idx, gen, use_cd):
            T.setdefault("data", {k: v.cpu().numpy() for k, v in data.items()})
            T["steps"].append((np.asarray(idx).tolist(), bool(use_cd)))
            return {"loss": torch.zeros(()), "mse": torch.zeros(()), "self_conditioned": 0.0}
        return step

    ttrain.create_train_state, ttrain.make_device_data_step = torch_create, torch_step
    tt.save_checkpoint = lambda *a, **k: None
    cfg = torch_config(CONFIG, [f"data.h5_path={npz}", f"train.output_dir={work}/torch_runs"])
    T["ema_decay"] = cfg.train.ema_decay
    tt.main(cfg, device="cpu")

    out = {}
    for k in ("total_steps", "lr", "adamw", "coin", "cond_drop_prob", "ema_decay"):
        out[k] = dict(jax=J[k], torch=T[k])
    first_cd = [next(i for i, (_, c) in enumerate(r["steps"]) if c) for r in (J, T)]
    out["chamfer_from_step"] = first_cd
    out["steps"] = [len(J["steps"]), len(T["steps"])]
    out["index_rows_equal"] = [a[0] for a in J["steps"]] == [b[0] for b in T["steps"]]
    out["data_max_abs_diff"] = {k: float(np.abs(J["data"][k].astype(np.float64)
                                                - T["data"][k]).max()) for k in J["data"]}
    print(json.dumps(out, indent=1))


def score(weights, side, seed):
    import torch

    from pcdiff_torch.cli.train import build_model
    from pcdiff_torch.core import flax_from_params
    from pcdiff_torch.core.config import load_config as torch_config

    work = os.path.dirname(os.path.abspath(weights))
    h5, npz = _fixtures(work)
    state = torch.load(weights)
    over = [f"train.seed={seed}", "sample.load_checkpoint_path=given"]
    t0 = time.time()
    cwd = os.getcwd()
    os.chdir(work)  # the evaluation log goes beside the weights
    try:
        if side == "torch":
            import pcdiff_torch.cli.evaluate as te

            te.load_params = lambda cfg, model: model.load_state_dict(state)
            summary = te.main(torch_config(CONFIG, [f"data.h5_path={npz}", *over]),
                              device="cpu")
        else:
            import pcdiff.cli.evaluate as je
            from pcdiff.core.config import load_config as jax_config

            model = build_model(torch_config(CONFIG, []), "cpu")
            model.load_state_dict(state)
            tree = {"params": flax_from_params(model)}
            je.load_params = lambda cfg, model, key: tree
            summary = je.main(jax_config(CONFIG, [f"data.h5_path={h5}", *over]))
    finally:
        os.chdir(cwd)
    print(json.dumps(dict(side=side, seed=seed, seconds=time.time() - t0,
                          **{k: float(v) for k, v in summary["overall"].items()})))


def train_jax(seed, out):
    import glob

    import jax
    import torch

    import pcdiff.cli.train as jt
    from pcdiff.cli.sample import load_params
    from pcdiff.core.config import load_config as jax_config
    from pcdiff_torch.core import params_from_flax

    os.makedirs(out, exist_ok=True)
    h5, _ = _fixtures(out)
    t0 = time.time()
    jt.main(jax_config(CONFIG, [f"data.h5_path={h5}", f"train.seed={seed}",
                                f"train.output_dir={out}/runs"]))
    seconds = time.time() - t0
    ckpt = sorted(glob.glob(os.path.join(out, "runs", "run_*", "checkpoints")))[-1]
    cfg = jax_config(CONFIG, [f"sample.load_checkpoint_path={ckpt}"])
    variables = load_params(cfg, jt.build_model(cfg), jax.random.PRNGKey(0))
    torch.save(params_from_flax(jax.device_get(variables)), os.path.join(out, "weights.pt"))
    print(json.dumps(dict(seed=seed, train_seconds=seconds, checkpoint=ckpt)))


def chance():
    import torch

    from pcdiff_torch.evals.metrics import CompletionMetrics

    rng = np.random.default_rng(0)
    metrics = CompletionMetrics(fps_points=1024, device="cpu")
    for _ in range(5):  # 80 clouds of 256 points, as the fixture's scans
        pred = rng.uniform(-0.5, 0.5, (16, 256, 3)).astype(np.float32)
        target = rng.uniform(-0.5, 0.5, (16, 256, 3)).astype(np.float32)
        metrics.update(torch.as_tensor(pred), target, np.zeros(16, int))
    print(json.dumps({k: float(v) for k, v in metrics.summary()["overall"].items()}))


def main(argv):
    cmd = argv[0]
    if cmd != "chance":
        _jax_cpu()
    if cmd == "schedules":
        with tempfile.TemporaryDirectory(prefix="pcdiff_bisect_") as work:
            schedules(work)
    elif cmd == "score":
        score(argv[1], argv[2], int(argv[3]))
    elif cmd == "train-jax":
        train_jax(int(argv[1]), argv[2])
    elif cmd == "chance":
        chance()
    else:
        raise SystemExit(__doc__)


if __name__ == "__main__":
    main(sys.argv[1:])
