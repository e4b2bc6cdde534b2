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
:func:`pcdiff.core.checkpoint.import_two_stream_torch_state` and then this function.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["params_from_flax", "init_params"]


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
