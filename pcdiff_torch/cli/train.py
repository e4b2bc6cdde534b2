"""Training entry point.

Counterpart of :mod:`pcdiff.cli.train`: builds the TwoStreamDenoiser and the Gaussian
diffusion from a config, runs the epochs with the chamfer curriculum (the chamfer term
from epoch ``start_chamfer + 1``), keeps an optional parameter EMA, saves the full train
state (and the EMA shadow under ``run_dir/ema``) every ``save_every`` epochs, resumes from
one with ``train.continue_training=true train.load_checkpoint_path=<run>/checkpoints``
(or starts from a reference ``.pt``), samples the epoch's last batch to PLY files every
``sample_every`` epochs, and writes ``metrics.jsonl``.

The datasets are ``modelnet``, ``mvp`` (``n_samples`` = ``model.num_points``; its labels run
1-16, so it wants ``model.num_classes=17``: with fewer classes the labels past the table
give NaN class tokens, as in the JAX package), ``multimodal`` and ``synthetic``. The
dataset lives on the device when ``train.device_data`` allows (``auto``: below 2 GB):
each step then sends one index row and permutes the targets on the device
(:func:`~pcdiff_torch.train.make_device_data_step`); otherwise the loader streams host
batches. On a card outside a data group the step's loss, backward and gradient norm are
replayed as CUDA graphs (:mod:`pcdiff_torch.train.graphs`: the eager step's launches, one
host call a step). Step metrics stay tensors until the end of the epoch, which reads them
at once.
Every random draw comes from one generator, seeded by ``train.seed`` and saved with the
state, so that a resumed run repeats an unbroken one.

Data parallel: under ``torchrun`` (``WORLD_SIZE`` > 1; NCCL, one card a process) or in a
process group started by the caller, each rank trains on its shard of the data (the
loader's ``process_index``/``process_count``: its rows of the device-data index table, or
its host batches), every rank's step generator is seeded alike so the draws are the global
batch's, and the step averages the gradients over the mesh's data group before the clip
and AdamW (:func:`~pcdiff_torch.train.make_train_step`'s ``data_group``);
``train.batch_size`` is a rank's, as in the JAX package. Rank 0 writes the config, the
metrics, the checkpoints and the sampled PLYs, and sends its generator's state to the
others after it samples; every rank resumes from the checkpoint.

Usage: ``python -m pcdiff_torch.cli.train [--config cfg.yaml] [--device cuda|cpu]
[key.path=value ...]``, or ``torchrun --nproc-per-node N -m pcdiff_torch.cli.train ...``
"""

from __future__ import annotations

import argparse
import datetime
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.checkpoint import (
    load_torch_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from ..core.config import Config, load_config, save_config
from ..core.device import resolve_device
from ..core.weights import init_params as _init_params
from ..data import (
    BatchLoader,
    ModelNetCompletion,
    MultiModalCompletion,
    MVPCompletion,
    make_modelnet_fixture,
)
from ..diffusion import diffusion_from_betas
from ..models import TwoStreamDenoiser
from ..parallel import initialize, make_mesh, replicate
from ..parallel.distributed import process_count, process_index
from ..parallel.mesh import data_group

logger = logging.getLogger("pcdiff_torch.train")

# 'auto' device_data threshold: the stacked normalised tensors must leave most of the
# card's memory to the train step's activations
_DEVICE_DATA_MAX_BYTES = 2e9


def stack_dataset(dataset, seed: int) -> Dict[str, np.ndarray]:
    """One normalised host copy of every dataset item, stacked per key. The per-item
    target permutation drawn here is redrawn on the device every step by the device-data
    path, so this fixed one adds no bias."""
    rng = np.random.default_rng(seed)
    items = [dataset.__getitem__(i, rng=rng) for i in range(len(dataset))]
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def _device_data_enabled(cfg: Config, dataset) -> bool:
    mode = getattr(cfg.train, "device_data", "auto")
    # YAML 1.1 reads a bare on/off as a bool
    mode = {True: "on", False: "off"}.get(mode, mode)
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"train.device_data must be auto, on or off, not {mode!r}")
    if mode != "auto":
        return mode == "on"
    sample = dataset.__getitem__(0, rng=np.random.default_rng(0))
    total = sum(np.asarray(v).nbytes for v in sample.values()) * len(dataset)
    return total < _DEVICE_DATA_MAX_BYTES


def build_model(cfg: Config, device="cuda") -> TwoStreamDenoiser:
    """The configured denoiser on ``device``, after setting the process-wide kernel
    switches the config names (the attention's exponentials, the MLPs' GELU) on every
    call. ``model.scan_blocks`` has no effect: the port has one parameter layout."""
    from ..models.attention import set_gelu_impl
    from ..ops.flash_attention import set_attention_softmax_dtype

    m = cfg.model
    set_attention_softmax_dtype(getattr(m, "softmax_dtype", "float32"))
    set_gelu_impl(getattr(m, "gelu_impl", "erf"))
    if m.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"model.compute_dtype must be float32 or bfloat16, "
                         f"not {m.compute_dtype!r}")
    return TwoStreamDenoiser(
        num_points=m.num_points, num_latents=m.num_latents,
        cond_drop_prob=m.cond_drop_prob, input_channels=m.input_channels,
        output_channels=m.output_channels, latent_dim=m.latent_dim,
        x_dim=m.x_dim, num_blocks=m.num_blocks,
        num_compute_layers=m.num_compute_layers, num_classes=m.num_classes,
        num_heads=m.num_heads, num_tokens_ppcd=m.num_tokens_ppcd,
        num_tokens_depth=m.num_tokens_depth,
        depth_image_size=m.depth_image_size, depth_patch=m.depth_patch,
        active_modalities=tuple(m.active_modalities),
        dtype=torch.bfloat16 if m.compute_dtype == "bfloat16" else torch.float32,
        device=device,
    )


def build_diffusion(cfg: Config):
    """The configured Gaussian diffusion: the schedule, step count, and the mean,
    variance and loss types of ``diffusion.gaussiandiffusion`` (a learned variance needs
    ``model.output_channels`` = 6)."""
    g = cfg.diffusion.gaussiandiffusion
    return diffusion_from_betas(cfg.diffusion.schedule, cfg.diffusion.timesteps,
                                model_mean_type=g.model_mean_type,
                                model_var_type=g.model_var_type, loss_type=g.loss_type)


def build_dataset(cfg: Config):
    name = cfg.data.dataset
    if name == "modelnet":
        return ModelNetCompletion(cfg.data.h5_path, split="train")
    if name == "mvp":
        return MVPCompletion(cfg.data.h5_path, prefix="train", n_samples=cfg.model.num_points)
    if name == "multimodal":
        return MultiModalCompletion(cfg.data.h5_path)
    if name == "synthetic":
        path = cfg.data.h5_path or os.path.join(cfg.train.output_dir, "pcdiff_synthetic.npz")
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            make_modelnet_fixture(path, num_points=cfg.model.num_points,
                                  depth_size=cfg.model.depth_image_size)
        return ModelNetCompletion(path, split="train", skip_classes=None)
    raise ValueError(f"unknown dataset: {name}")


def init_params(model: TwoStreamDenoiser, cfg: Config, generator: torch.Generator
                ) -> TwoStreamDenoiser:
    """Initialise ``model``'s parameters from ``generator`` (the JAX package's
    initialisers); returns the model."""
    del cfg
    return _init_params(model, generator)


def _ema_dir(checkpoint_dir: str) -> str:
    return os.path.join(os.path.dirname(os.path.normpath(checkpoint_dir)), "ema")


def _broadcast_object(obj, group):
    """Rank 0's ``obj`` on every rank of ``group`` (``obj`` itself without one)."""
    if group is None:
        return obj
    import torch.distributed as dist

    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0), group=group)
    return box[0]


def _sync_generator(generator: torch.Generator, group) -> None:
    """Give every rank of ``group`` rank 0's state of ``generator``."""
    if group is None:
        return
    generator.set_state(_broadcast_object(generator.get_state(), group))


def main(cfg: Config, device="cuda") -> Dict[str, Any]:
    """Train as configured on ``device`` (the card unless the caller asks for the CPU),
    data parallel over the process group where one is started (see the module's
    docstring). Returns a summary: ``run_dir``, ``resumed_step``, ``global_step``,
    ``device_data``, per-epoch ``epochs`` (steps, seconds of steps, mean loss), the rank
    and world size, whether the step averaged over a data group (``data_parallel``), the
    final ``state`` and ``ema``."""
    from ..core.logging import MetricsLogger, profile_trace
    from ..train import (
        create_train_state,
        ema_update,
        init_ema,
        make_device_data_step,
        make_train_step,
    )

    dev = resolve_device(device)
    initialize(device=dev)
    mesh = make_mesh(dev.type)
    group = data_group(mesh)
    rank, world = process_index(), process_count()
    lead = rank == 0
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s", force=True)
    timestamp = datetime.datetime.now().strftime("%d-%m-%Y_%H-%M")
    run_dir = _broadcast_object(os.path.join(cfg.train.output_dir, f"run_{timestamp}"), group)
    if lead:
        os.makedirs(run_dir, exist_ok=True)
        save_config(cfg, os.path.join(run_dir, "config_used.yaml"))
    logger.info("starting run: %s on %s (rank %d of %d)", run_dir, dev, rank, world)

    # seeded alike on every rank: a step's draws are the global batch's
    gen = torch.Generator(device=dev).manual_seed(cfg.train.seed)
    model = init_params(build_model(cfg, dev), cfg, gen)
    diffusion = build_diffusion(cfg)
    dataset = build_dataset(cfg)
    loader = BatchLoader(dataset, cfg.train.batch_size, seed=cfg.train.seed,
                         process_index=rank, process_count=world)
    total_steps = len(loader) * cfg.train.epochs

    path = cfg.train.load_checkpoint_path
    full_resume = cfg.train.continue_training and bool(path) and not path.endswith(".pt")
    if cfg.train.continue_training and path.endswith(".pt"):
        logger.info("importing reference torch checkpoint: %s", path)
        model.load_state_dict(load_torch_checkpoint(path))
    replicate(mesh, model)

    state = create_train_state(model, lr=cfg.train.lr, weight_decay=cfg.train.weight_decay,
                               total_steps=max(total_steps, 1), device=dev)
    ema = init_ema(model) if cfg.train.ema_decay > 0 else None
    resumed_step = 0
    if full_resume:
        state, resumed_step = restore_checkpoint(path, state, generator=gen)
        logger.info("restored full train state at step %d", resumed_step)
        if ema is not None and os.path.isdir(_ema_dir(path)):
            restore_checkpoint(_ema_dir(path), ema, step=resumed_step)
            logger.info("restored EMA shadow at step %d", resumed_step)

    use_device_data = _device_data_enabled(cfg, dataset)
    step_kwargs = dict(self_conditioning_prob=cfg.train.self_conditioning_prob,
                       bootstrap_include_partial_pcd=cfg.train.bootstrap_include_partial_pcd,
                       data_group=group, device=dev, cuda_graphs=True)
    if use_device_data:
        step_fn = make_device_data_step(model, diffusion, **step_kwargs)
        host_data = stack_dataset(dataset, cfg.train.seed)
        data_dev = {k: torch.as_tensor(v, device=dev) for k, v in host_data.items()}
        logger.info("device-resident dataset: %d items, %.2f GB on device", len(dataset),
                    sum(v.nbytes for v in host_data.values()) / 1e9)
    else:
        step_fn = make_train_step(model, diffusion, **step_kwargs)

    mlog = MetricsLogger(run_dir, project=cfg.wandb.project,
                         run_name=os.path.basename(run_dir), use_wandb=cfg.wandb.enabled,
                         is_lead_host=lead)
    global_step = resumed_step
    start_epoch = resumed_step // max(len(loader), 1)
    epochs = []
    for epoch in range(start_epoch, cfg.train.epochs):
        loader.set_epoch(epoch)
        use_cd = epoch + 1 > cfg.train.start_chamfer
        t0 = time.perf_counter()
        last_batch = None
        step_metrics = []  # tensors, read once at the end of the epoch
        profiling = bool(cfg.train.profile_dir) and epoch == 1 and lead
        with profile_trace(cfg.train.profile_dir or None, enabled=profiling):
            if use_device_data:
                idx_table = loader.epoch_indices()
                for row in idx_table:
                    metrics = step_fn(state, data_dev, row, gen, use_cd)
                    if ema is not None:
                        ema_update(ema, model, cfg.train.ema_decay)
                    step_metrics.append(metrics)
                if len(idx_table):
                    last_batch = {k: v[idx_table[-1]] for k, v in host_data.items()}
            else:
                for batch in loader:
                    last_batch = batch
                    metrics = step_fn(state, batch, gen, use_cd)
                    if ema is not None:
                        ema_update(ema, model, cfg.train.ema_decay)
                    step_metrics.append(metrics)
            # the kl losses have no mse term; a learned variance adds vb
            keys = [k for k in ("loss", "mse", "vb") if step_metrics and k in step_metrics[0]]
            host = (torch.stack([torch.stack([m[k] for k in keys]) for m in step_metrics])
                    .cpu().tolist() if step_metrics else [])
        step_seconds = time.perf_counter() - t0
        for values, m in zip(host, step_metrics):
            global_step += 1
            mlog.log(dict(zip(keys, values), self_conditioned=m["self_conditioned"]),
                     step=global_step)
        if last_batch is not None and (epoch + 1) % cfg.train.sample_every == 0:
            if lead:
                _sample_last_batch(cfg, model, diffusion, last_batch, run_dir, epoch + 1, gen)
            _sync_generator(gen, group)
        if host:
            mean_loss = sum(v[0] for v in host) / len(host)
            epochs.append(dict(epoch=epoch + 1, steps=len(host), step_seconds=step_seconds,
                               loss=mean_loss))
            logger.info("epoch %d: avg loss %.4f (%d steps, %.1fs)", epoch + 1, mean_loss,
                        len(host), time.perf_counter() - t0)
            if (lead and (epoch + 1) % cfg.train.save_every == 0
                    and cfg.train.save_full_state):
                save_checkpoint(os.path.join(run_dir, "checkpoints"), global_step, state,
                                generator=gen, epoch=epoch + 1)
                if ema is not None:
                    save_checkpoint(os.path.join(run_dir, "ema"), global_step, ema,
                                    epoch=epoch + 1)
                logger.info("saved checkpoint at step %d", global_step)
    mlog.finish()
    if group is not None:
        import torch.distributed as dist

        dist.barrier(group=group)  # the lead's last checkpoint is whole before any rank returns
    return dict(run_dir=run_dir, resumed_step=resumed_step, global_step=global_step,
                device_data=use_device_data, epochs=epochs, rank=rank, world=world,
                data_parallel=group is not None, state=state, ema=ema)


def _sample_last_batch(cfg: Config, model, diffusion, batch, run_dir: str, epoch: int,
                       generator: torch.Generator) -> None:
    """Sample the epoch's last batch with the current parameters and save its partials,
    targets and samples as PLY files."""
    from ..models.wrapper import BoundTwoStream
    from ..utils.io import save_samples, save_target_point_clouds
    from .sample import batch_kwargs, build_sampler

    sampler = build_sampler(cfg, BoundTwoStream(model.eval()))
    samples = sampler.sample_batch(len(batch["target"]),
                                   batch_kwargs(batch, generator.device), generator)
    save_target_point_clouds(np.asarray(batch["partial_pcd"]),
                             os.path.join(run_dir, f"partial_pcd_epoch_{epoch}"),
                             prefix="partial_pcd")
    save_target_point_clouds(np.asarray(batch["target"]),
                             os.path.join(run_dir, f"target_points_epoch_{epoch}"),
                             prefix="target_points")
    save_samples(samples.float().cpu().numpy(),
                 os.path.join(run_dir, f"samples_epoch_{epoch}"))
    logger.info("saved qualitative samples for epoch %d", epoch)


def parse_args(argv=None, description: Optional[str] = None):
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--config", default=None)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu, for the plain PyTorch versions")
    parser.add_argument("overrides", nargs="*")
    return parser.parse_args(argv)


def cli(argv=None):
    args = parse_args(argv, __doc__)
    try:
        main(load_config(args.config, args.overrides), device=args.device)
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    cli()
