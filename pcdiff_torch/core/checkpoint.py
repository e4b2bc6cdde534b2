"""Checkpoints: the port's full train state and bare parameter sets, and the reference's
``.pt`` weights.

Counterpart of :mod:`pcdiff.core.checkpoint`. A checkpoint is the directory
``<directory>/<step>/`` holding ``state.pt`` (``torch.save``; read back with
``torch.load(weights_only=True)``) and ``meta.json`` (its step, its kind and the epoch).
Two kinds:

- ``train_state``, from a :class:`~pcdiff_torch.train.TrainState`: the model's
  parameters, the AdamW moments and step counts, the schedule step, the states of the
  step generator and of torch's default CPU and CUDA generators, and the epoch;
- ``params``, a bare ``{name: tensor}`` set such as the EMA shadow, which the train
  driver saves under ``run_dir/ema/<step>``.

The JAX package's Orbax checkpoints are not read here (that would need JAX). The
reference's ``.pt`` weights map onto the port's parameters through the flax-shaped tree
and :func:`~pcdiff_torch.core.weights.params_from_flax`
(:func:`import_two_stream_torch_state`, :func:`load_torch_checkpoint`), and back
(:func:`export_two_stream_torch_state`).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = [
    "save_checkpoint",
    "restore_checkpoint",
    "latest_checkpoint_step",
    "checkpoint_meta",
    "load_weights",
    "import_two_stream_torch_state",
    "load_torch_checkpoint",
    "export_two_stream_torch_state",
]


# ------------------------------------------------------------- the port's own

def _step_dirs(directory: str) -> Dict[int, str]:
    if not os.path.isdir(directory):
        return {}
    return {int(n): os.path.join(directory, n) for n in os.listdir(directory)
            if n.isdigit() and os.path.isfile(os.path.join(directory, n, "meta.json"))}


def latest_checkpoint_step(directory: str) -> Optional[int]:
    """The largest step saved in ``directory``, or None."""
    steps = _step_dirs(directory)
    return max(steps) if steps else None


def _resolve(directory: str, step: Optional[int]) -> Tuple[str, int]:
    step = latest_checkpoint_step(directory) if step is None else step
    if step is None or step not in _step_dirs(directory):
        raise FileNotFoundError(f"no checkpoint{'' if step is None else f' at step {step}'} "
                                f"in {directory}")
    return os.path.join(directory, str(step)), step


def checkpoint_meta(directory: str, step: Optional[int] = None) -> Dict[str, Any]:
    """``meta.json`` of the checkpoint at ``step`` (the latest by default): ``step``,
    ``kind`` (``train_state`` or ``params``) and ``epoch``."""
    path, _ = _resolve(directory, step)
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def _is_train_state(obj) -> bool:
    return hasattr(obj, "optimizer") and hasattr(obj, "model")


def save_checkpoint(directory: str, step: int, state, *,
                    generator: Optional[torch.Generator] = None, epoch: Optional[int] = None,
                    max_to_keep: Optional[int] = None) -> str:
    """Save ``state`` (a ``TrainState``, or a ``{name: tensor}`` mapping) as the
    checkpoint ``<directory>/<step>``, replacing one at the same step; with a TrainState
    also ``generator``'s state and torch's default generators'. The directory is written
    under a temporary name and renamed, so a checkpoint is either whole or absent.
    Returns its path."""
    if _is_train_state(state):
        payload: Dict[str, Any] = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "schedule_step": int(state.step),
            "generators": {
                "step": None if generator is None else generator.get_state(),
                "cpu": torch.get_rng_state(),
                "cuda": torch.cuda.get_rng_state_all() if torch.cuda.is_initialized()
                else [],
            },
        }
        kind = "train_state"
    elif isinstance(state, Mapping):
        payload = {k: v.detach() for k, v in state.items()}
        kind = "params"
    else:
        raise TypeError(f"cannot checkpoint a {type(state).__name__}")
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(int(step)))
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, "state.pt"))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": int(step), "kind": kind, "epoch": epoch}, f)
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    if max_to_keep is not None:
        for old in sorted(_step_dirs(directory))[:-max_to_keep]:
            shutil.rmtree(os.path.join(directory, str(old)))
    return final


def _load(path: str) -> Dict[str, Any]:
    return torch.load(os.path.join(path, "state.pt"), map_location="cpu", weights_only=True)


@torch.no_grad()
def _copy_into(targets: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor],
               what: str) -> None:
    if set(targets) != set(source):
        missing, extra = sorted(set(targets) - set(source)), sorted(set(source) - set(targets))
        raise KeyError(f"{what}: names differ (missing {missing[:5]}, extra {extra[:5]})")
    for name, t in targets.items():
        if t.shape != source[name].shape:
            raise ValueError(f"{what}: {name} has shape {tuple(source[name].shape)}, "
                             f"expected {tuple(t.shape)}")
        t.copy_(source[name])


def restore_checkpoint(directory: str, state_template, step: Optional[int] = None, *,
                       generator: Optional[torch.Generator] = None):
    """Restore the checkpoint at ``step`` (the latest by default) into
    ``state_template``, in place, and return ``(state_template, step)``.

    A ``TrainState`` takes a ``train_state`` checkpoint: parameters, optimizer state,
    schedule step, and the generators' states (``generator``'s when given, and torch's
    default ones). A ``{name: tensor}`` mapping or an ``nn.Module`` takes the parameters
    of either kind (a ``train_state``'s model, or a bare set)."""
    path, step = _resolve(directory, step)
    with open(os.path.join(path, "meta.json")) as f:
        kind = json.load(f)["kind"]
    payload = _load(path)
    if _is_train_state(state_template):
        if kind != "train_state":
            raise ValueError(f"{path} holds {kind}, not a train state")
        state_template.model.load_state_dict(payload["model"])
        state_template.optimizer.load_state_dict(payload["optimizer"])
        state_template.step = payload["schedule_step"]
        gens = payload["generators"]
        if generator is not None:
            if gens["step"] is None:
                raise ValueError(f"{path} holds no step generator state")
            generator.set_state(gens["step"])
        torch.set_rng_state(gens["cpu"])
        if gens["cuda"] and torch.cuda.is_available():
            torch.cuda.set_rng_state_all(gens["cuda"])
        return state_template, step
    weights = payload["model"] if kind == "train_state" else payload
    if isinstance(state_template, nn.Module):
        _copy_into(dict(state_template.named_parameters()), weights, path)
    else:
        _copy_into(state_template, weights, path)
    return state_template, step


def load_weights(path: str, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The model parameters (CPU tensors, by the port's names) held by ``path``: a
    reference ``.pt`` file, or a checkpoint directory of either kind."""
    if path.endswith(".pt"):
        return load_torch_checkpoint(path)
    ckpt, _ = _resolve(path, step)
    with open(os.path.join(ckpt, "meta.json")) as f:
        kind = json.load(f)["kind"]
    payload = _load(ckpt)
    return payload["model"] if kind == "train_state" else payload


# ------------------------------------------------ reference torch checkpoints

def _t(x) -> np.ndarray:
    arr = x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    return arr.astype(np.float32)


def _linear(sd, prefix):
    out = {"kernel": _t(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _t(sd[f"{prefix}.bias"])
    return out


def _layernorm(sd, prefix):
    return {"scale": _t(sd[f"{prefix}.weight"]), "bias": _t(sd[f"{prefix}.bias"])}


def _mlp(sd, prefix):
    # timm-style Mlp: fc1 -> act -> fc2
    return {"fc1": _linear(sd, f"{prefix}.fc1"), "fc2": _linear(sd, f"{prefix}.fc2")}


def _rin_attn(sd, prefix):
    return {
        "wq": _linear(sd, f"{prefix}.wq"),
        "wk": _linear(sd, f"{prefix}.wk"),
        "wv": _linear(sd, f"{prefix}.wv"),
        "proj": _linear(sd, f"{prefix}.proj"),
    }


def _torch_mha(sd, prefix):
    """torch.nn.MultiheadAttention -> separate wq/wk/wv/proj."""
    w = _t(sd[f"{prefix}.in_proj_weight"])  # [3D, D]
    b = _t(sd[f"{prefix}.in_proj_bias"])
    D = w.shape[1]
    wq, wk, wv = w[:D], w[D : 2 * D], w[2 * D :]
    bq, bk, bv = b[:D], b[D : 2 * D], b[2 * D :]
    return {
        "wq": {"kernel": wq.T, "bias": bq},
        "wk": {"kernel": wk.T, "bias": bk},
        "wv": {"kernel": wv.T, "bias": bv},
        "proj": _linear(sd, f"{prefix}.out_proj"),
    }


def _torch_encoder_layer(sd, prefix):
    """torch TransformerEncoderLayer(norm_first) -> pcdiff EncoderLayer."""
    return {
        "norm1": _layernorm(sd, f"{prefix}.norm1"),
        "norm2": _layernorm(sd, f"{prefix}.norm2"),
        "self_attn": _torch_mha(sd, f"{prefix}.self_attn"),
        "mlp": {
            "fc1": _linear(sd, f"{prefix}.linear1"),
            "fc2": _linear(sd, f"{prefix}.linear2"),
        },
    }


def _torch_decoder_layer(sd, prefix):
    """torch TransformerDecoderLayer(norm_first) -> pcdiff DecoderLayer."""
    return {
        "norm1": _layernorm(sd, f"{prefix}.norm1"),
        "norm2": _layernorm(sd, f"{prefix}.norm2"),
        "norm3": _layernorm(sd, f"{prefix}.norm3"),
        "self_attn": _torch_mha(sd, f"{prefix}.self_attn"),
        "cross_attn": _torch_mha(sd, f"{prefix}.multihead_attn"),
        "mlp": {
            "fc1": _linear(sd, f"{prefix}.linear1"),
            "fc2": _linear(sd, f"{prefix}.linear2"),
        },
    }


def _count_layers(sd, pattern):
    rx = re.compile(pattern)
    idxs = {int(m.group(1)) for k in sd for m in [rx.match(k)] if m}
    return (max(idxs) + 1) if idxs else 0


def _rin_block(sd, prefix, kind):
    """Read/Write/Compute block param subtrees."""
    if kind == "read":
        norms = {"norm_x": "norm_x", "norm_z1": "norm_z1", "norm_z2": "norm_z2"}
    elif kind == "write":
        norms = {"norm_z": "norm_z", "norm_x1": "norm_x1", "norm_x2": "norm_x2"}
    else:
        norms = {"norm_z1": "norm_z1", "norm_z2": "norm_z2"}
    out = {v: _layernorm(sd, f"{prefix}.{k}") for k, v in norms.items()}
    out["attn"] = _rin_attn(sd, f"{prefix}.attn")
    out["mlp"] = _mlp(sd, f"{prefix}.mlp")
    return out


def _query_decoder(sd, prefix, num_layers):
    # stored [1, T-1, D]; our param keeps the leading axis
    out = {"token_queries": _t(sd[f"{prefix}.token_queries"])}
    for i in range(num_layers // 2):
        out[f"decoder_{i}"] = _torch_decoder_layer(sd, f"{prefix}.decoder.layers.{i}")
        out[f"refiner_{i}"] = _torch_encoder_layer(
            sd, f"{prefix}.query_refiner.layers.{i}"
        )
    out["proj_out"] = _linear(sd, f"{prefix}.proj_out")
    out["ln_out"] = _layernorm(sd, f"{prefix}.ln_out")
    return out


def flax_tree_from_torch_state(state_dict: Dict[str, Any]) -> Dict[str, Any]:
    """A reference TwoStreamDenoiser ``state_dict`` as the flax-shaped parameter tree
    ``{"params": tree}`` of the JAX package's TwoStreamDenoiser (numpy arrays)."""
    sd = state_dict
    p: Dict[str, Any] = {}

    # ----- backbone
    bb_prefix = "denoiser_backbone"
    bb: Dict[str, Any] = {
        "input_proj": _linear(sd, f"{bb_prefix}.input_proj"),
        "ln_pre": _layernorm(sd, f"{bb_prefix}.ln_pre"),
        "z_init": _t(sd[f"{bb_prefix}.z_init"]),
        "time_embed": _mlp(sd, f"{bb_prefix}.time_embed"),
        "latent_mlp": _mlp(sd, f"{bb_prefix}.latent_mlp"),
        "ln_latent": _layernorm(sd, f"{bb_prefix}.ln_latent"),
        "ln_post": _layernorm(sd, f"{bb_prefix}.ln_post"),
        "output_proj": _linear(sd, f"{bb_prefix}.output_proj"),
    }
    n_blocks = _count_layers(sd, rf"{bb_prefix}\.blocks\.(\d+)\.")
    for i in range(n_blocks):
        bp = f"{bb_prefix}.blocks.{i}"
        block = {
            "read": _rin_block(sd, f"{bp}.read", "read"),
            "write": _rin_block(sd, f"{bp}.write", "write"),
        }
        n_compute = _count_layers(sd, rf"{re.escape(bp)}\.compute\.(\d+)\.")
        for j in range(n_compute):
            block[f"compute_{j}"] = _rin_block(sd, f"{bp}.compute.{j}", "compute")
        bb[f"block_{i}"] = block
    p["backbone"] = bb

    # ----- modality encoders
    if "encoders.class.embedding.weight" in sd:
        p["encoders_class"] = {
            "embedding": {"embedding": _t(sd["encoders.class.embedding.weight"])},
            "norm": _layernorm(sd, "encoders.class.norm"),
        }
    if "encoders.view.mlp.0.weight" in sd:
        p["encoders_view"] = {
            "fc1": _linear(sd, "encoders.view.mlp.0"),
            "fc2": _linear(sd, "encoders.view.mlp.2"),
            "fc3": _linear(sd, "encoders.view.mlp.4"),
            "norm": _layernorm(sd, "encoders.view.mlp.5"),
        }
    if "encoders.partial_pcd.input_proj.weight" in sd:
        pref = "encoders.partial_pcd"
        n_layers = _count_layers(sd, rf"{re.escape(pref)}\.encoder\.layers\.(\d+)\.")
        enc: Dict[str, Any] = {
            "input_proj": _linear(sd, f"{pref}.input_proj"),
            "cls_token": _t(sd[f"{pref}.cls_token"]),
        }
        for i in range(n_layers):
            enc[f"encoder_{i}"] = _torch_encoder_layer(
                sd, f"{pref}.encoder.layers.{i}"
            )
        enc["query_decoder"] = _query_decoder(sd, pref, n_layers)
        p["encoders_partial_pcd"] = enc
    if "encoders.depth.proj.weight" in sd:
        pref = "encoders.depth"
        n_layers = _count_layers(sd, rf"{re.escape(pref)}\.mixer\.layers\.(\d+)\.")
        conv_w = _t(sd[f"{pref}.proj.weight"])  # OIHW
        enc = {
            "patch_proj": {
                "kernel": conv_w.transpose(2, 3, 1, 0),  # OIHW -> HWIO
                "bias": _t(sd[f"{pref}.proj.bias"]),
            },
            "cls_token": _t(sd[f"{pref}.cls_token"]),
        }
        for i in range(n_layers):
            enc[f"mixer_{i}"] = _torch_encoder_layer(sd, f"{pref}.mixer.layers.{i}")
        enc["query_decoder"] = _query_decoder(sd, pref, n_layers)
        p["encoders_depth"] = enc

    if "token_type_embeddings.weight" in sd:
        p["token_type_embeddings"] = {
            "embedding": _t(sd["token_type_embeddings.weight"])
        }
    return {"params": p}


def import_two_stream_torch_state(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A reference TwoStreamDenoiser ``state_dict`` as the port's ``state_dict`` (fp32
    CPU tensors), through the flax-shaped tree."""
    from .weights import params_from_flax

    return params_from_flax(flax_tree_from_torch_state(state_dict))


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """Load a reference ``.pt`` checkpoint as the port's ``state_dict``."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return import_two_stream_torch_state(sd)


# --------------------------------------------------- back to the reference's names


def _inv_linear(out: Dict, prefix: str, tree: Dict) -> None:
    out[f"{prefix}.weight"] = np.asarray(tree["kernel"]).T
    if "bias" in tree:
        out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _inv_layernorm(out: Dict, prefix: str, tree: Dict) -> None:
    out[f"{prefix}.weight"] = np.asarray(tree["scale"])
    out[f"{prefix}.bias"] = np.asarray(tree["bias"])


def _inv_mlp(out: Dict, prefix: str, tree: Dict) -> None:
    _inv_linear(out, f"{prefix}.fc1", tree["fc1"])
    _inv_linear(out, f"{prefix}.fc2", tree["fc2"])


def _inv_rin_attn(out: Dict, prefix: str, tree: Dict) -> None:
    for name in ("wq", "wk", "wv", "proj"):
        _inv_linear(out, f"{prefix}.{name}", tree[name])


def _inv_torch_mha(out: Dict, prefix: str, tree: Dict) -> None:
    wq, wk, wv = (np.asarray(tree[n]["kernel"]).T for n in ("wq", "wk", "wv"))
    bq, bk, bv = (np.asarray(tree[n]["bias"]) for n in ("wq", "wk", "wv"))
    out[f"{prefix}.in_proj_weight"] = np.concatenate([wq, wk, wv], axis=0)
    out[f"{prefix}.in_proj_bias"] = np.concatenate([bq, bk, bv], axis=0)
    _inv_linear(out, f"{prefix}.out_proj", tree["proj"])


def _inv_encoder_layer(out: Dict, prefix: str, tree: Dict) -> None:
    _inv_layernorm(out, f"{prefix}.norm1", tree["norm1"])
    _inv_layernorm(out, f"{prefix}.norm2", tree["norm2"])
    _inv_torch_mha(out, f"{prefix}.self_attn", tree["self_attn"])
    _inv_linear(out, f"{prefix}.linear1", tree["mlp"]["fc1"])
    _inv_linear(out, f"{prefix}.linear2", tree["mlp"]["fc2"])


def _inv_decoder_layer(out: Dict, prefix: str, tree: Dict) -> None:
    for n in ("norm1", "norm2", "norm3"):
        _inv_layernorm(out, f"{prefix}.{n}", tree[n])
    _inv_torch_mha(out, f"{prefix}.self_attn", tree["self_attn"])
    _inv_torch_mha(out, f"{prefix}.multihead_attn", tree["cross_attn"])
    _inv_linear(out, f"{prefix}.linear1", tree["mlp"]["fc1"])
    _inv_linear(out, f"{prefix}.linear2", tree["mlp"]["fc2"])


def _inv_rin_block(out: Dict, prefix: str, tree: Dict, kind: str) -> None:
    norms = {
        "read": ("norm_x", "norm_z1", "norm_z2"),
        "write": ("norm_z", "norm_x1", "norm_x2"),
        "compute": ("norm_z1", "norm_z2"),
    }[kind]
    for n in norms:
        _inv_layernorm(out, f"{prefix}.{n}", tree[n])
    _inv_rin_attn(out, f"{prefix}.attn", tree["attn"])
    _inv_mlp(out, f"{prefix}.mlp", tree["mlp"])


def _inv_query_decoder(out: Dict, prefix: str, tree: Dict) -> None:
    out[f"{prefix}.token_queries"] = np.asarray(tree["token_queries"])
    i = 0
    while f"decoder_{i}" in tree:
        _inv_decoder_layer(out, f"{prefix}.decoder.layers.{i}", tree[f"decoder_{i}"])
        _inv_encoder_layer(
            out, f"{prefix}.query_refiner.layers.{i}", tree[f"refiner_{i}"]
        )
        i += 1
    _inv_linear(out, f"{prefix}.proj_out", tree["proj_out"])
    _inv_layernorm(out, f"{prefix}.ln_out", tree["ln_out"])


def export_two_stream_torch_state(model: nn.Module,
                                  tensors: Optional[Mapping[str, torch.Tensor]] = None
                                  ) -> Dict[str, np.ndarray]:
    """The port's TwoStreamDenoiser parameters (``tensors`` named as ``model``'s, its
    own by default) as a reference-style ``state_dict`` of numpy arrays: the inverse of
    :func:`import_two_stream_torch_state`. Buffers that the reference recomputes (position
    embeddings, the token-type template) are not emitted."""
    from .weights import flax_from_params

    variables = flax_from_params(model, tensors)
    p = variables["params"] if "params" in variables else variables
    out: Dict[str, np.ndarray] = {}

    bb = p["backbone"]
    pre = "denoiser_backbone"
    _inv_linear(out, f"{pre}.input_proj", bb["input_proj"])
    _inv_layernorm(out, f"{pre}.ln_pre", bb["ln_pre"])
    out[f"{pre}.z_init"] = np.asarray(bb["z_init"])
    _inv_mlp(out, f"{pre}.time_embed", bb["time_embed"])
    _inv_mlp(out, f"{pre}.latent_mlp", bb["latent_mlp"])
    _inv_layernorm(out, f"{pre}.ln_latent", bb["ln_latent"])
    _inv_layernorm(out, f"{pre}.ln_post", bb["ln_post"])
    _inv_linear(out, f"{pre}.output_proj", bb["output_proj"])
    i = 0
    while f"block_{i}" in bb:
        blk = bb[f"block_{i}"]
        _inv_rin_block(out, f"{pre}.blocks.{i}.read", blk["read"], "read")
        _inv_rin_block(out, f"{pre}.blocks.{i}.write", blk["write"], "write")
        j = 0
        while f"compute_{j}" in blk:
            _inv_rin_block(
                out, f"{pre}.blocks.{i}.compute.{j}", blk[f"compute_{j}"],
                "compute",
            )
            j += 1
        i += 1

    if "encoders_class" in p:
        out["encoders.class.embedding.weight"] = np.asarray(
            p["encoders_class"]["embedding"]["embedding"]
        )
        _inv_layernorm(out, "encoders.class.norm", p["encoders_class"]["norm"])
    if "encoders_view" in p:
        v = p["encoders_view"]
        _inv_linear(out, "encoders.view.mlp.0", v["fc1"])
        _inv_linear(out, "encoders.view.mlp.2", v["fc2"])
        _inv_linear(out, "encoders.view.mlp.4", v["fc3"])
        _inv_layernorm(out, "encoders.view.mlp.5", v["norm"])
    if "encoders_partial_pcd" in p:
        e = p["encoders_partial_pcd"]
        _inv_linear(out, "encoders.partial_pcd.input_proj", e["input_proj"])
        out["encoders.partial_pcd.cls_token"] = np.asarray(e["cls_token"])
        i = 0
        while f"encoder_{i}" in e:
            _inv_encoder_layer(
                out, f"encoders.partial_pcd.encoder.layers.{i}", e[f"encoder_{i}"]
            )
            i += 1
        _inv_query_decoder(out, "encoders.partial_pcd", e["query_decoder"])
    if "encoders_depth" in p:
        e = p["encoders_depth"]
        out["encoders.depth.proj.weight"] = np.asarray(
            e["patch_proj"]["kernel"]
        ).transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out["encoders.depth.proj.bias"] = np.asarray(e["patch_proj"]["bias"])
        out["encoders.depth.cls_token"] = np.asarray(e["cls_token"])
        i = 0
        while f"mixer_{i}" in e:
            _inv_encoder_layer(
                out, f"encoders.depth.mixer.layers.{i}", e[f"mixer_{i}"]
            )
            i += 1
        _inv_query_decoder(out, "encoders.depth", e["query_decoder"])

    if "token_type_embeddings" in p:
        out["token_type_embeddings.weight"] = np.asarray(
            p["token_type_embeddings"]["embedding"]
        )
    return out
