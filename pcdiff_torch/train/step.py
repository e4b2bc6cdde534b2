"""The training step: self-conditioning bootstrap + diffusion loss.

Counterpart of :mod:`pcdiff.train.step` (``make_loss_fn`` / ``make_train_step``) with the
modality encoders shared between the two forwards (``share_cond_encoders``, the JAX
package's default and the one path ported):

- t ~ U{0, .., T-1}, Gaussian noise, and one coin per step that decides, with probability
  ``self_conditioning_prob``, whether a bootstrap forward makes ``prev_latent``;
- the encoders run once per step, in train mode (dropout); the bootstrap sees the
  encoded modalities without ``partial_pcd`` unless ``bootstrap_include_partial_pcd``,
  and runs under ``torch.no_grad()``; each of the two forwards draws its own CFG-dropout
  masks;
- the diffusion's ``training_losses`` (any mean, variance and loss type; with a learned
  variance the model's output has twice the data's channels) plus the chamfer-XYZ term
  gated by a flag;
- ``backward``, the AdamW update and ``grad_norm``, the global norm of the raw gradients.

:func:`make_device_data_step` takes its batch from a dataset held on the device, by an
index row, and permutes each target's points on the device first.

Every random draw of a step comes from one explicit generator, in this order: t, noise,
the coin (:func:`draw_step_randoms`), then the dropout masks. The loss takes t, noise and
the coin as arguments, so that a test can hand it the JAX package's draws. The coin is
read on the host (one synchronisation per step), where the JAX package branches with
``lax.cond``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch
from torch import nn

from ..core.device import resolve_device
from ..diffusion.gaussian import GaussianDiffusion
from ..models.attention import dropout_generator
from .state import TrainState, global_norm

__all__ = ["make_loss_fn", "make_train_step", "make_device_data_step", "draw_step_randoms",
           "permute_points"]

_COND_KEYS = ("class_labels", "viewpoints", "partial_pcd", "depth_maps")


def draw_step_randoms(target: torch.Tensor, num_timesteps: int,
                      self_conditioning_prob: float, generator: torch.Generator
                      ) -> Tuple[torch.Tensor, torch.Tensor, bool]:
    """(t [B], noise like ``target``, the self-conditioning coin) from ``generator``."""
    b, dev = target.shape[0], target.device
    t = torch.randint(0, num_timesteps, (b,), generator=generator, device=dev)
    noise = torch.randn(target.shape, generator=generator, device=dev, dtype=target.dtype)
    coin = torch.rand((), generator=generator, device=dev) < self_conditioning_prob
    return t, noise, bool(coin)


def make_loss_fn(model: nn.Module, diffusion: GaussianDiffusion, *,
                 bootstrap_include_partial_pcd: bool = False):
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
        raw = model.encode_modalities(b, **{k: batch.get(k) for k in _COND_KEYS})
        boot_raw = dict(raw)
        if not bootstrap_include_partial_pcd:
            boot_raw["partial_pcd"] = None

        if use_sc:
            with torch.no_grad():
                cond_b = model.assemble_conditioning(boot_raw, b)
                _, latent = model(x_t, t, cond_tokens=cond_b)
            prev_latent = latent.detach()
        else:
            prev_latent = torch.zeros(b, model.latent_tokens, model.latent_dim,
                                      dtype=model.dtype, device=target.device)

        def model_fn(x, tt):
            cond_m = model.assemble_conditioning(raw, b)
            return model(x, tt, cond_tokens=cond_m, prev_latent=prev_latent)

        terms = diffusion.training_losses(model_fn, target, t, noise,
                                          use_cd_xyz_loss=use_cd_xyz)
        metrics: Dict[str, Any] = {k: v.detach().mean() for k, v in terms.items()}
        metrics["self_conditioned"] = float(use_sc)
        return terms["loss"].mean(), metrics

    return loss_fn


def _make_update(model: nn.Module, diffusion: GaussianDiffusion, *,
                 self_conditioning_prob: float, bootstrap_include_partial_pcd: bool, dev):
    """``update(state, batch, generator, use_cd_xyz) -> metrics`` on a batch of tensors
    on ``dev``, which the model must lie on."""
    wrong = {str(p.device) for p in model.parameters() if p.device.type != dev.type}
    if wrong:
        raise ValueError(f"the model's parameters lie on {sorted(wrong)}, not on {dev}")
    loss_fn = make_loss_fn(model, diffusion,
                           bootstrap_include_partial_pcd=bootstrap_include_partial_pcd)

    def update(state: TrainState, batch: Dict[str, torch.Tensor], generator: torch.Generator,
               use_cd_xyz: Union[bool, torch.Tensor]) -> Dict[str, Any]:
        t, noise, use_sc = draw_step_randoms(batch["target"], diffusion.num_timesteps,
                                             self_conditioning_prob, generator)
        model.train()
        params = state.params
        for p in params:
            p.grad = None
        with dropout_generator(generator):
            loss, metrics = loss_fn(batch, t, noise, use_sc, use_cd_xyz)
        loss.backward()
        grad_norm = global_norm(p.grad for p in params if p.grad is not None)
        state.apply_gradients(grad_norm)
        metrics["grad_norm"] = grad_norm
        return metrics

    return update


def make_train_step(model: nn.Module, diffusion: GaussianDiffusion, *,
                    self_conditioning_prob: float = 0.6,
                    bootstrap_include_partial_pcd: bool = False, device="cuda"):
    """``step(state, batch, generator, use_cd_xyz) -> metrics``: one update of ``state``
    (in place) on ``batch`` (arrays or tensors, moved to ``device``), every random draw
    from ``generator``. ``device`` is the card unless the caller asks for the CPU; the
    model must lie on it."""
    dev = resolve_device(device)
    update = _make_update(model, diffusion, self_conditioning_prob=self_conditioning_prob,
                          bootstrap_include_partial_pcd=bootstrap_include_partial_pcd,
                          dev=dev)

    def step(state: TrainState, batch: Dict[str, Any], generator: torch.Generator,
             use_cd_xyz: Union[bool, torch.Tensor]) -> Dict[str, Any]:
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        return update(state, batch, generator, use_cd_xyz)

    return step


def permute_points(target: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Each sample's points [B, N, C] in its own uniformly random order, drawn from
    ``generator`` on the target's device: the argsort of B x N fp64 uniforms (a tie, which
    would bias the order, has odds of about N^2 / 2^54 a sample)."""
    keys = torch.rand(target.shape[:2], generator=generator, device=target.device,
                      dtype=torch.float64)
    order = keys.argsort(dim=1)
    return torch.gather(target, 1, order[..., None].expand_as(target))


def make_device_data_step(model: nn.Module, diffusion: GaussianDiffusion, *,
                          self_conditioning_prob: float = 0.6,
                          bootstrap_include_partial_pcd: bool = False, device="cuda"):
    """``step(state, data, idx, generator, use_cd_xyz) -> metrics``: as
    :func:`make_train_step`, on the batch gathered by the index row ``idx`` [B] from
    ``data``, a dataset held on the device (``{key: [items, ...] tensor}``, the normalised
    items stacked). Each sample's ``target`` gets a fresh permutation of its points from
    ``generator`` before the step's other draws: the distribution of the loader path's
    per-item permutation, from the step's own stream."""
    dev = resolve_device(device)
    update = _make_update(model, diffusion, self_conditioning_prob=self_conditioning_prob,
                          bootstrap_include_partial_pcd=bootstrap_include_partial_pcd,
                          dev=dev)

    def step(state: TrainState, data: Dict[str, torch.Tensor], idx, generator: torch.Generator,
             use_cd_xyz: Union[bool, torch.Tensor]) -> Dict[str, Any]:
        idx = torch.as_tensor(idx, device=dev, dtype=torch.long)
        batch = {k: v.index_select(0, idx) for k, v in data.items()}
        batch["target"] = permute_points(batch["target"], generator)
        return update(state, batch, generator, use_cd_xyz)

    return step
