"""The training step: self-conditioning bootstrap + diffusion loss.

Counterpart of :mod:`pcdiff.train.step` (``make_loss_fn`` / ``make_train_step`` /
``make_device_data_step``):

- t ~ U{0, .., T-1}, Gaussian noise, and one coin per step that decides, with probability
  ``self_conditioning_prob``, whether a bootstrap forward makes ``prev_latent``;
- ``share_cond_encoders`` (the default, as in the JAX package): the encoders run once per
  step, in train mode (dropout), and both forwards share their tokens; the bootstrap sees
  them without ``partial_pcd`` unless ``bootstrap_include_partial_pcd``, and each of the
  two forwards draws its own CFG-dropout masks. ``share_cond_encoders=False`` (the
  reference's composition): each forward runs the encoders itself, with its own
  train-dropout and CFG-dropout draws; the bootstrap's conditioning omits ``partial_pcd``
  unless ``bootstrap_include_partial_pcd``. The bootstrap runs under ``torch.no_grad()``
  either way;
- the diffusion's ``training_losses`` (any mean, variance and loss type; with a learned
  variance the model's output has twice the data's channels) plus the chamfer-XYZ term
  gated by a flag;
- ``backward``, the AdamW update and ``grad_norm``, the global norm of the gradients.

:func:`make_device_data_step` takes its batch from a dataset held on the device, by an
index row, and permutes each target's points on the device first.

Every random draw of a step comes from one explicit generator, in this order: the target
permutation (device-data step only), t, noise, the coin (:func:`draw_step_randoms`), then
the dropout masks as the forwards run. Shared: the encoders' dropout, the bootstrap's CFG
masks (on a coin step), the main forward's CFG masks. Unshared: on a coin step the
bootstrap's encoders' dropout and its CFG masks, then the main forward's encoders' dropout
and its CFG masks. The loss takes t, noise and the coin as arguments, so that a test can
hand it the JAX package's draws. The coin is read on the host (one synchronisation per
step), where the JAX package branches with ``lax.cond``.

Data parallel (``data_group``, a process group of ranks that each hold an equal shard of a
global batch, rank order = row order): every draw is made at the global batch from a
generator seeded alike on every rank, and each rank takes its own rows
(:func:`~pcdiff_torch.models.attention.draw_sharded`), so the ranks draw together what one
process draws for the whole batch; after ``backward`` the gradients are averaged over the
group by one all-reduce (the all-reduce that XLA inserts under the JAX package's sharded
step), before the clip, ``grad_norm`` and AdamW, and the metrics are averaged too. The
loss is the mean of equal shards' means. One exception: a modality's presence is the
any-nonzero check of the rank's own rows, which equals the global batch's unless a whole
shard of that modality is zero.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch
from torch import nn

from ..core.device import resolve_device
from ..diffusion.gaussian import GaussianDiffusion
from ..models.attention import draw_sharded, dropout_generator
from .state import TrainState, global_norm

__all__ = ["make_loss_fn", "make_train_step", "make_device_data_step", "draw_step_randoms",
           "permute_points", "average_gradients"]

_COND_KEYS = ("class_labels", "viewpoints", "partial_pcd", "depth_maps")

Shard = Optional[Tuple[int, int]]


def draw_step_randoms(target: torch.Tensor, num_timesteps: int,
                      self_conditioning_prob: float, generator: torch.Generator,
                      shard: Shard = None) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """(t [B], noise like ``target``, the self-conditioning coin) from ``generator``; with
    ``shard = (i, n)``, shard i's rows of the draws for n shards like ``target``."""
    dev = target.device
    t = draw_sharded(lambda s: torch.randint(0, num_timesteps, s, generator=generator,
                                             device=dev), target.shape[:1], shard)
    noise = draw_sharded(lambda s: torch.randn(s, generator=generator, device=dev,
                                               dtype=target.dtype), target.shape, shard)
    coin = torch.rand((), generator=generator, device=dev) < self_conditioning_prob
    return t, noise, bool(coin)


def make_loss_fn(model: nn.Module, diffusion: GaussianDiffusion, *,
                 bootstrap_include_partial_pcd: bool = False,
                 share_cond_encoders: bool = True):
    """``loss_fn(batch, t, noise, use_sc, use_cd_xyz) -> (loss, metrics)``: the step's
    loss for the given draws, dropout masks from the generator of
    :func:`~pcdiff_torch.models.attention.dropout_generator`. Run it with the model in
    train mode. The coin, drawn with ``self_conditioning_prob`` in
    :func:`draw_step_randoms`, is its argument ``use_sc``."""

    def loss_fn(batch: Dict[str, torch.Tensor], t: torch.Tensor, noise: torch.Tensor,
                use_sc: bool, use_cd_xyz: Union[bool, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        target = batch["target"]
        b = target.shape[0]
        x_t = diffusion.q_sample(target, t, noise)
        cond = {k: batch.get(k) for k in _COND_KEYS}
        if share_cond_encoders:
            raw = model.encode_modalities(b, **cond)
            boot_raw = dict(raw)
            if not bootstrap_include_partial_pcd:
                boot_raw["partial_pcd"] = None

        if use_sc:
            with torch.no_grad():
                if share_cond_encoders:
                    cond_b = model.assemble_conditioning(boot_raw, b)
                else:
                    boot = dict(cond)
                    if not bootstrap_include_partial_pcd:
                        boot["partial_pcd"] = None
                    cond_b = model.encode_conditioning(b, **boot)
                _, latent = model(x_t, t, cond_tokens=cond_b)
            prev_latent = latent.detach()
        else:
            prev_latent = torch.zeros(b, model.latent_tokens, model.latent_dim,
                                      dtype=model.dtype, device=target.device)

        def model_fn(x, tt):
            if share_cond_encoders:
                cond_m = model.assemble_conditioning(raw, b)
            else:
                cond_m = model.encode_conditioning(b, **cond)
            return model(x, tt, cond_tokens=cond_m, prev_latent=prev_latent)

        terms = diffusion.training_losses(model_fn, target, t, noise,
                                          use_cd_xyz_loss=use_cd_xyz)
        metrics: Dict[str, Any] = {k: v.detach().mean() for k, v in terms.items()}
        metrics["self_conditioned"] = float(use_sc)
        return terms["loss"].mean(), metrics

    return loss_fn


def average_gradients(params, group) -> None:
    """Average ``params``' gradients over the process group ``group`` in place: one
    all-reduce a dtype over the flattened gradients. A missing gradient takes part as
    zeros (as optax sees it), so every rank reduces the same layout, and stays missing
    where the average is zero."""
    import torch.distributed as dist

    world = dist.get_world_size(group)
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        by_dtype.setdefault(p.dtype, []).append(p)
    for ps in by_dtype.values():
        flat = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in ps])
        dist.all_reduce(flat, group=group)
        flat /= world
        offset = 0
        for p in ps:
            part = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
            if p.grad is not None:
                p.grad.copy_(part)
            elif part.any():
                p.grad = part.clone()


def _average_metrics(metrics: Dict[str, Any], group) -> None:
    import torch.distributed as dist

    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    flat = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    metrics.update(zip(keys, flat.unbind()))


def _shard_of(group) -> Shard:
    if group is None:
        return None
    import torch.distributed as dist

    return dist.get_rank(group), dist.get_world_size(group)


def _make_update(model: nn.Module, diffusion: GaussianDiffusion, *,
                 self_conditioning_prob: float, bootstrap_include_partial_pcd: bool,
                 share_cond_encoders: bool, data_group, dev, cuda_graphs: bool = False):
    """``update(state, batch, generator, use_cd_xyz) -> metrics`` on a batch of tensors
    on ``dev``, which the model must lie on. With ``cuda_graphs``, on a card and without
    a data group, the loss, ``backward`` and the norm run as CUDA graphs
    (:class:`~pcdiff_torch.train.graphs.StepGraphs`; a tensor chamfer flag runs eagerly)."""
    wrong = {str(p.device) for p in model.parameters() if p.device.type != dev.type}
    if wrong:
        raise ValueError(f"the model's parameters lie on {sorted(wrong)}, not on {dev}")
    loss_fn = make_loss_fn(model, diffusion,
                           bootstrap_include_partial_pcd=bootstrap_include_partial_pcd,
                           share_cond_encoders=share_cond_encoders)
    shard = _shard_of(data_group)
    graphs = None

    def forward(batch, t, noise, use_sc, use_cd_xyz, generator):
        with dropout_generator(generator, shard):
            return loss_fn(batch, t, noise, use_sc, use_cd_xyz)

    def update(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator,
               use_cd_xyz: Union[bool, torch.Tensor]) -> Dict[str, Any]:
        nonlocal graphs
        t, noise, use_sc = draw_step_randoms(batch["target"], diffusion.num_timesteps,
                                             self_conditioning_prob, generator, shard)
        model.train()
        params = state.params
        if (cuda_graphs and dev.type == "cuda" and data_group is None
                and not isinstance(use_cd_xyz, torch.Tensor)):
            if graphs is None:
                from .graphs import StepGraphs

                graphs = StepGraphs(forward, dev)
            metrics, grad_norm = graphs.run(params, batch, t, noise, use_sc,
                                            bool(use_cd_xyz), generator)
            state.apply_gradients(grad_norm)
            metrics["grad_norm"] = grad_norm
            return metrics
        for p in params:
            p.grad = None
        loss, metrics = forward(batch, t, noise, use_sc, use_cd_xyz, generator)
        loss.backward()
        if data_group is not None:
            average_gradients(params, data_group)
            _average_metrics(metrics, data_group)
        grad_norm = global_norm(p.grad for p in params if p.grad is not None)
        state.apply_gradients(grad_norm)
        metrics["grad_norm"] = grad_norm
        return metrics

    return update


def make_train_step(model: nn.Module, diffusion: GaussianDiffusion, *,
                    self_conditioning_prob: float = 0.6,
                    bootstrap_include_partial_pcd: bool = False,
                    share_cond_encoders: bool = True, data_group=None, device="cuda",
                    cuda_graphs: bool = False):
    """``step(state, batch, generator, use_cd_xyz) -> metrics``: one update of ``state``
    (in place) on ``batch`` (arrays or tensors, moved to ``device``), every random draw
    from ``generator``. ``device`` is the card unless the caller asks for the CPU; the
    model must lie on it. With ``data_group`` the batch is this rank's shard of the
    global batch (see the module's docstring). ``cuda_graphs`` replays the loss and its
    backward as CUDA graphs on a card (the same launches; see :mod:`.graphs`)."""
    dev = resolve_device(device)
    update = _make_update(model, diffusion, self_conditioning_prob=self_conditioning_prob,
                          bootstrap_include_partial_pcd=bootstrap_include_partial_pcd,
                          share_cond_encoders=share_cond_encoders, data_group=data_group,
                          dev=dev, cuda_graphs=cuda_graphs)

    def step(state: TrainState, batch: Dict[str, Any], generator: torch.Generator,
             use_cd_xyz: Union[bool, torch.Tensor]) -> Dict[str, Any]:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        return update(state, batch, generator, use_cd_xyz)

    return step


def permute_points(target: torch.Tensor, generator: torch.Generator,
                   shard: Shard = None) -> torch.Tensor:
    """Each sample's points [B, N, C] in its own uniformly random order, drawn from
    ``generator`` on the target's device: the argsort of B x N fp64 uniforms (a tie, which
    would bias the order, has odds of about N^2 / 2^54 a sample). ``shard`` as in
    :func:`draw_step_randoms`."""
    keys = draw_sharded(lambda s: torch.rand(s, generator=generator, device=target.device,
                                             dtype=torch.float64), target.shape[:2], shard)
    order = keys.argsort(dim=1)
    return torch.gather(target, 1, order[..., None].expand_as(target))


def make_device_data_step(model: nn.Module, diffusion: GaussianDiffusion, *,
                          self_conditioning_prob: float = 0.6,
                          bootstrap_include_partial_pcd: bool = False,
                          share_cond_encoders: bool = True, data_group=None, device="cuda",
                          cuda_graphs: bool = False):
    """``step(state, data, idx, generator, use_cd_xyz) -> metrics``: as
    :func:`make_train_step`, on the batch gathered by the index row ``idx`` [B] from
    ``data``, a dataset held on the device (``{key: [items, ...] tensor}``, the normalised
    items stacked). Each sample's ``target`` gets a fresh permutation of its points from
    ``generator`` before the step's other draws: the distribution of the loader path's
    per-item permutation, from the step's own stream. With ``data_group``, ``idx`` is this
    rank's row of the global batch's indices."""
    dev = resolve_device(device)
    update = _make_update(model, diffusion, self_conditioning_prob=self_conditioning_prob,
                          bootstrap_include_partial_pcd=bootstrap_include_partial_pcd,
                          share_cond_encoders=share_cond_encoders, data_group=data_group,
                          dev=dev, cuda_graphs=cuda_graphs)
    shard = _shard_of(data_group)

    def step(state: TrainState, data: Dict[str, torch.Tensor], idx, generator: torch.Generator,
             use_cd_xyz: Union[bool, torch.Tensor]) -> Dict[str, Any]:
        idx = torch.as_tensor(idx, device=dev, dtype=torch.long)
        batch = {k: v.index_select(0, idx) for k, v in data.items()}
        batch["target"] = permute_points(batch["target"], generator, shard)
        return update(state, batch, generator, use_cd_xyz)

    return step
