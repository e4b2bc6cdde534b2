"""Parameters: seeded initialisation, and the JAX package's parameter trees as a
``state_dict`` of the port.

Counterpart of the importers in :mod:`pcdiff.core.checkpoint`. The port's modules carry
the names of the flax tree (``backbone.block_0.read.attn.wq``, ...), so the mapping is one
to one; only the leaves change:

- Dense ``kernel [in, out]`` -> ``weight [out, in]`` (the ``nn.Linear`` layout that the
  kernels and ``F.linear`` take);
- Conv ``kernel`` HWIO -> ``weight`` OIHW;
- LayerNorm ``scale`` -> ``weight``; Embed ``embedding`` -> ``weight``;
- raw parameters (``z_init``, ``cls_token``, ``token_queries``) as they are.

Both the unrolled ``block_i`` layout and the stacked ``blocks/block`` layout of
``scan_blocks=True`` are accepted; the stacked one is unstacked in numpy. A reference
torch checkpoint reaches the port through
:func:`pcdiff.core.checkpoint.import_two_stream_torch_state` and then this function. The
Point-E family's trees carry across the same way: the denoisers, the perceiver and the SDF
model (``backbone/resblock_i``, ``clip_embed_ln``, ...) and CLIP (``visual/block_i``, the
patch conv without a bias, the raw ``class_embedding``, ``proj``, ``text_projection`` and
the 0-d ``logit_scale``); the port's own importers of the reference's ``state_dict`` files
are :mod:`pcdiff_torch.core.point_e_import` and
:func:`pcdiff_torch.models.clip.import_clip_torch_state`.
:func:`flax_from_params` is the inverse, for parameters or for gradients.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["params_from_flax", "flax_from_params", "init_params"]


def _unstack_blocks(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """Scanned ``blocks/block`` subtrees (leading block axis) -> ``block_0..block_{n-1}``."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if k == "blocks" and isinstance(v, Mapping) and set(v) == {"block"}:
            stacked = _flatten(v["block"])
            n = next(iter(stacked.values())).shape[0]
            for i in range(n):
                out[f"block_{i}"] = _nest({p: a[i] for p, a in stacked.items()})
        elif isinstance(v, Mapping):
            out[k] = _unstack_blocks(v)
        else:
            out[k] = v
    return out


def _flatten(tree: Mapping[str, Any], prefix: tuple = ()) -> Dict[tuple, np.ndarray]:
    flat: Dict[tuple, np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (k,)))
        else:
            flat[prefix + (k,)] = np.asarray(v)
    return flat


def _nest(flat: Mapping[tuple, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, arr in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr
    return tree


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax parameter tree (nested dicts of arrays, with or without the top ``params``
    key) -> the port's ``state_dict`` (fp32 tensors on the CPU)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(_unstack_blocks(tree)).items():
        *mods, leaf = path
        if leaf == "kernel" and arr.ndim == 2:
            leaf, arr = "weight", arr.T
        elif leaf == "kernel" and arr.ndim == 4:
            leaf, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        elif leaf == "kernel":
            raise ValueError(f"unexpected kernel rank {arr.ndim} at {'/'.join(path)}")
        name = ".".join([*mods, leaf])
        state[name] = torch.tensor(arr, dtype=torch.float32)
    return state


def flax_from_params(module: nn.Module,
                     tensors: Optional[Mapping[str, torch.Tensor]] = None) -> Dict[str, Any]:
    """The inverse of :func:`params_from_flax`: ``tensors`` (named as ``module``'s
    parameters; its parameters themselves by default, or e.g. their gradients) -> a flax
    parameter tree of fp32 numpy copies, without the top ``params`` key, in the unrolled
    ``block_i`` layout. Dense weights go back to ``kernel [in, out]``, the patch conv to
    HWIO, LayerNorm weights to ``scale`` and embeddings to ``embedding``."""
    from ..models.attention import Dense, LayerNorm
    from ..models.encoders import Embed, PatchConv

    if tensors is None:
        tensors = dict(module.named_parameters())
    owners = {}
    for mod_name, mod in module.named_modules():
        for p_name, _ in mod.named_parameters(recurse=False):
            owners[f"{mod_name}.{p_name}" if mod_name else p_name] = mod
    flat: Dict[tuple, np.ndarray] = {}
    for name, t in tensors.items():
        if name not in owners:
            raise KeyError(f"{name} is no parameter of the module")
        owner = owners[name]
        arr = np.array(t.detach().float().cpu())  # a copy: never a view of a live tensor
        *mods, leaf = name.split(".")
        if leaf == "weight" and isinstance(owner, Dense):
            leaf, arr = "kernel", arr.T
        elif leaf == "weight" and isinstance(owner, PatchConv):
            leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
        elif leaf == "weight" and isinstance(owner, LayerNorm):
            leaf = "scale"
        elif leaf == "weight" and isinstance(owner, Embed):
            leaf = "embedding"
        flat[tuple(mods) + (leaf,)] = np.ascontiguousarray(arr)
    return _nest(flat)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialise every parameter from ``generator`` with the JAX package's initialisers
    (xavier-uniform projections, zero biases, unit LayerNorms with ``ln_latent`` zeroed,
    normal embeddings and tokens, truncated-normal patch conv). Returns ``module``."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return module
