"""The flagship model as the sampler's duck-typed callable, with the sampling hooks.

Counterpart of :mod:`pcdiff.models.wrapper`:

- ``cached_model_kwargs``: encode the conditioning once per sampling run instead of at
  every ODE sub-step;
- ``cfg_model_kwargs``: the 2B-row CFG kwargs, conditional rows then zero rows (with
  every modality absent, eval-mode conditioning tokens are exactly zero);
- ``init_latent``: zeros for the RIN self-conditioning carry.

``calls`` counts the denoiser calls, so a run can check how many the solver made.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from .two_stream import TwoStreamDenoiser

__all__ = ["BoundTwoStream"]

_COND_KEYS = ("class_labels", "viewpoints", "partial_pcd", "depth_maps", "presence")


class BoundTwoStream:
    """A TwoStreamDenoiser with sampling-time caching hooks and a call counter."""

    def __init__(self, module: TwoStreamDenoiser):
        self.module = module
        self.calls = 0

    @property
    def point_mesh(self):
        """(mesh, axis) that shard the module's x-stream, or None
        (:func:`pcdiff_torch.parallel.xsp.point_mesh`)."""
        return self.module.backbone.point_mesh

    def __call__(self, x, t, **kwargs):
        self.calls += 1
        return self.module(x, t, **kwargs)

    def cached_model_kwargs(self, batch_size: int, model_kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """Replace the raw modality inputs with precomputed conditioning tokens."""
        if "cond_tokens" in model_kwargs:
            return model_kwargs
        cond = self.module.encode_conditioning(
            batch_size, **{k: model_kwargs.get(k) for k in _COND_KEYS})
        out = {k: v for k, v in model_kwargs.items() if k not in _COND_KEYS}
        out["cond_tokens"] = cond
        return out

    def cfg_model_kwargs(self, batch_size: int, model_kwargs: Dict[str, Any]) -> Dict[str, Any]:
        """2B-batched kwargs for CFG: the conditional rows, then the all-absent rows."""
        kwargs = self.cached_model_kwargs(batch_size, model_kwargs)
        out = dict(kwargs)
        for k, v in kwargs.items():
            if k != "prev_latent":
                out[k] = torch.cat([v, torch.zeros_like(v)], dim=0)
        return out

    def init_latent(self, batch_size: int) -> torch.Tensor:
        m = self.module
        return torch.zeros(batch_size, m.latent_tokens, m.latent_dim, dtype=m.dtype,
                           device=m.token_type_embeddings.weight.device)
