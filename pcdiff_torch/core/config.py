"""Typed configuration: frozen dataclasses, a YAML file merged over their defaults, and
dotted-path overrides.

Counterpart of :mod:`pcdiff.core.config`, with the same dataclasses, defaults and
functions. The port reads and writes YAML without PyYAML, through its own reader of the
subset that the repo's configs use:

- ``#`` comments, blank lines, and nested block mappings indented by spaces;
- scalars: ``null``/``~``, YAML 1.1's booleans (``true``, ``false``, ``yes``, ``no``,
  ``on``, ``off`` in their three cases), decimal ints, floats (``3.0e-4``, ``.5``,
  ``.inf``, ``.nan``; ``1e-4`` too, read as a float as the JAX package's
  ``_parse_value`` reads it), and plain, single- or double-quoted strings;
- flow lists of scalars, ``[class, view, partial_pcd, depth]``.

Anything else (block sequences, flow mappings, anchors, tags, block scalars, several
documents, tabs, octal, hex or sexagesimal numbers, duplicate keys) raises a
:class:`ConfigSyntaxError` with its line number. :func:`save_config` writes the same
subset, in a form that ``yaml.safe_load`` reads back to the same values.
"""

from __future__ import annotations

import dataclasses
import math
import re
import typing
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "WandbConfig",
    "DataConfig",
    "TrainConfig",
    "ModelConfig",
    "GaussianDiffusionConfig",
    "DiffusionConfig",
    "SampleConfig",
    "Config",
    "ConfigSyntaxError",
    "load_config",
    "apply_overrides",
    "to_dict",
    "save_config",
    "parse_yaml",
    "dump_yaml",
]


@dataclass(frozen=True)
class WandbConfig:
    project: str = "pointcloud_diffusion"
    enabled: bool = False


@dataclass(frozen=True)
class DataConfig:
    h5_path: str = ""
    dataset: str = "modelnet"  # modelnet | synthetic (mvp | multimodal: not ported)


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    num_workers: int = 8
    epochs: int = 500
    lr: float = 3e-4
    weight_decay: float = 0.01
    seed: int = 42
    self_conditioning_prob: float = 0.6
    save_every: int = 10
    sample_every: int = 100
    start_chamfer: int = 120
    output_dir: str = "./outputs"
    continue_training: bool = False
    load_checkpoint_path: str = ""
    # the reference's self-conditioning bootstrap forward omits partial_pcd
    bootstrap_include_partial_pcd: bool = False
    # save the full train state (parameters, moments, schedule step, generators, epoch)
    save_full_state: bool = True
    # parameter EMA decay; 0 disables (the reference keeps no EMA)
    ema_decay: float = 0.0
    # torch.profiler trace directory ('' disables); the second epoch is traced
    profile_dir: str = ""
    # device-resident dataset (auto | on | off): the stacked normalised dataset on the
    # device and one index row a step; 'auto' takes it below 2 GB
    device_data: str = "auto"


@dataclass(frozen=True)
class ModelConfig:
    num_points: int = 1024
    num_latents: int = 256
    cond_drop_prob: float = 0.1
    input_channels: int = 3
    output_channels: int = 3
    latent_dim: int = 256
    x_dim: int = 256
    num_blocks: int = 6
    num_compute_layers: int = 4
    num_heads: int = 8
    num_classes: int = 10
    num_tokens_ppcd: int = 256
    num_tokens_depth: int = 128
    active_modalities: Tuple[str, ...] = ("class", "view", "partial_pcd", "depth")
    depth_image_size: int = 512
    depth_patch: int = 32
    compute_dtype: str = "float32"  # float32 | bfloat16
    # dtype of the attention forward's exponentials (float32 | bfloat16)
    softmax_dtype: str = "float32"
    # GELU of the transformer MLPs (erf | tanh)
    gelu_impl: str = "erf"
    # the JAX package's compile-time lever (lax.scan over the RCW blocks); accepted and
    # without effect here: the port's checkpoints have one layout
    scan_blocks: bool = False


@dataclass(frozen=True)
class GaussianDiffusionConfig:
    model_mean_type: str = "epsilon"
    model_var_type: str = "fixed_small"
    loss_type: str = "mse"


@dataclass(frozen=True)
class DiffusionConfig:
    gaussiandiffusion: GaussianDiffusionConfig = field(
        default_factory=GaussianDiffusionConfig)
    schedule: str = "linear"
    timesteps: int = 1000


@dataclass(frozen=True)
class SampleConfig:
    num_samples: int = 32
    load_checkpoint_path: str = ""
    save_format: str = "ply"  # ply | npz
    output_dir: str = "./samples"
    guidance_scale: float = 3.0
    use_karras: bool = True
    karras_steps: int = 64
    sigma_min: float = 1e-3
    sigma_max: float = 120.0
    s_churn: float = 0.0
    # ODE solver: heun | heun_reuse (dpm | ancestral | heun_parallel: not ported)
    sampler: str = "heun"
    parallel_window: int = 8
    parallel_tol: float = 1e-3
    # CFG only while sigma is in [lo, hi]; off when hi <= lo (the default)
    guidance_interval_lo: float = 0.0
    guidance_interval_hi: float = 0.0


@dataclass(frozen=True)
class Config:
    wandb: WandbConfig = field(default_factory=WandbConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    sample: SampleConfig = field(default_factory=SampleConfig)


# ----------------------------------------------------------------- the YAML subset

class ConfigSyntaxError(ValueError):
    """YAML outside the subset the port reads, with its line number."""

    def __init__(self, line: int, message: str):
        super().__init__(f"line {line}: {message}")
        self.line = line


_BOOLS = {w: v for v, words in ((True, ("yes", "true", "on")), (False, ("no", "false", "off")))
          for word in words for w in (word, word.capitalize(), word.upper())}
_NULLS = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*\.[0-9_]*|\.[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*[eE][-+]?[0-9]+")
_SPECIAL_FLOATS = {".inf": math.inf, ".Inf": math.inf, ".INF": math.inf,
                   "+.inf": math.inf, "+.Inf": math.inf, "+.INF": math.inf,
                   "-.inf": -math.inf, "-.Inf": -math.inf, "-.INF": -math.inf,
                   ".nan": math.nan, ".NaN": math.nan, ".NAN": math.nan}
# other YAML 1.1 numbers (octal, hex, binary, sexagesimal): outside the subset
_OTHER_NUMBER = re.compile(r"[-+]?(?:0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+|"
                           r"[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_INDICATORS = tuple("&*!|>%@`{}[]?,'\"")


def _strip_comment(text: str) -> str:
    """``text`` up to a ``#`` that starts a comment (at the start or after white space,
    outside quotes)."""
    quote, skip = None, False
    for i, ch in enumerate(text):
        if skip:
            skip = False
        elif quote:
            if quote == "'" and text[i:i + 2] == "''":
                skip = True  # an escaped quote
            elif quote == '"' and ch == "\\":
                skip = True
            elif ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t[,"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i]
    return text


def _quoted(text: str, line: int) -> Tuple[str, str]:
    """(the quoted string at the start of ``text``, the rest)."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        ch = text[i]
        if q == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc not in ('"', "\\", "n", "t", "/"):
                raise ConfigSyntaxError(line, f"escape \\{esc} outside the subset")
            out.append({"n": "\n", "t": "\t"}.get(esc, esc))
            i += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), text[i + 1:]
        out.append(ch)
        i += 1
    raise ConfigSyntaxError(line, "unterminated quoted string")


def _plain(text: str, line: int) -> Any:
    """Resolve a plain (unquoted) scalar."""
    if text in _NULLS:
        return None
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.fullmatch(text):
        return int(text.replace("_", ""))
    if text in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text]
    if _FLOAT.fullmatch(text):
        return float(text.replace("_", ""))
    if _OTHER_NUMBER.fullmatch(text):
        raise ConfigSyntaxError(line, f"number {text!r} outside the subset (octal, hex, "
                                      "binary or sexagesimal)")
    if text.startswith(_INDICATORS) or text.startswith(("- ", "-\t")) or text == "-" \
            or ": " in text or text.endswith(":") or "\t" in text:
        raise ConfigSyntaxError(line, f"{text!r} is outside the YAML subset")
    return text


def _scalar(text: str, line: int) -> Any:
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, line)
        if rest.strip():
            raise ConfigSyntaxError(line, f"text after a quoted string: {rest.strip()!r}")
        return value
    return _plain(text, line)


def _flow_list(text: str, line: int) -> List[Any]:
    """``[a, b, 'c']``: a flow list of scalars."""
    inner = text.strip()[1:]
    items: List[Any] = []
    while True:
        inner = inner.lstrip()
        if inner.startswith("]") and not items:
            rest = inner[1:]
            break
        if inner[:1] in ("'", '"'):
            value, inner = _quoted(inner, line)
            items.append(value)
        else:
            m = re.match(r"[^,\]]*", inner)
            token = m.group(0).strip()
            if not token or token[:1] in ("[", "{"):
                raise ConfigSyntaxError(line, "flow lists hold scalars only")
            items.append(_plain(token, line))
            inner = inner[m.end():]
        inner = inner.lstrip()
        if inner.startswith(","):
            inner = inner[1:]
            continue
        if inner.startswith("]"):
            rest = inner[1:]
            break
        raise ConfigSyntaxError(line, "unterminated flow list")
    if rest.strip():
        raise ConfigSyntaxError(line, f"text after a flow list: {rest.strip()!r}")
    return items


def _value(text: str, line: int) -> Any:
    text = text.strip()
    if text.startswith("["):
        return _flow_list(text, line)
    return _scalar(text, line)


def parse_yaml(text: str) -> Dict[str, Any]:
    """The mapping that ``text`` (YAML of the subset above) holds; ``{}`` for an empty
    document."""
    lines = []
    for n, raw in enumerate(text.splitlines(), start=1):
        if raw.startswith("%") or raw.rstrip() in ("---", "..."):
            raise ConfigSyntaxError(n, "directives and document markers are outside the "
                                       "subset")
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        indent = len(body) - len(body.lstrip(" "))
        if body[indent:indent + 1] == "\t" or "\t" in body[:indent]:
            raise ConfigSyntaxError(n, "tabs in indentation")
        lines.append((n, indent, body[indent:]))

    root: Dict[str, Any] = {}
    # (indent of the mapping's keys, the mapping); a key with no inline value opens a
    # nested mapping whose indent the next line fixes
    stack: List[Tuple[int, Dict[str, Any]]] = [(0, root)]
    pending: Optional[Tuple[int, Dict[str, Any], str]] = None
    for n, indent, body in lines:
        if pending is not None:
            p_indent, p_map, p_key = pending
            pending = None
            if indent > p_indent:
                child: Dict[str, Any] = {}
                p_map[p_key] = child
                stack.append((indent, child))
            else:
                p_map[p_key] = None
        while stack and indent < stack[-1][0]:
            stack.pop()
        if not stack or indent != stack[-1][0]:
            raise ConfigSyntaxError(n, "indentation does not match any open mapping")
        mapping = stack[-1][1]
        if body.startswith(("- ", "-\t")) or body == "-":
            raise ConfigSyntaxError(n, "block sequences are outside the subset")
        m = _KEY.match(body)
        if not m or body[m.end():m.end() + 1] != ":" or \
                body[m.end() + 1:m.end() + 2] not in ("", " "):
            raise ConfigSyntaxError(n, f"expected 'key: value', got {body!r}")
        key, rest = m.group(0), body[m.end() + 1:]
        if key in mapping:
            raise ConfigSyntaxError(n, f"duplicate key {key!r}")
        if rest.strip():
            mapping[key] = _value(rest, n)
        else:
            mapping[key] = None
            pending = (indent, mapping, key)
    return root


def _dump_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "." not in text and "e" in text:  # YAML 1.1 floats need the dot: 1e-06 -> 1.0e-06
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        plain = re.fullmatch(r"[A-Za-z0-9_./][A-Za-z0-9_./+-]*", value) is not None
        try:
            plain = plain and _plain(value, 0) == value
        except ConfigSyntaxError:
            plain = False
        return value if plain else "'" + value.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(value).__name__} {value!r} in the YAML subset")


def dump_yaml(data: Dict[str, Any], indent: int = 0) -> str:
    """``data`` (nested dicts of scalars and lists of scalars) as YAML of the subset."""
    out = []
    for key, value in data.items():
        if not _KEY.fullmatch(str(key)):
            raise TypeError(f"cannot write key {key!r} in the YAML subset")
        pad = " " * indent
        if isinstance(value, dict):
            out.append(f"{pad}{key}:\n" + dump_yaml(value, indent + 2) if value
                       else f"{pad}{key}: null\n")
        elif isinstance(value, (list, tuple)):
            out.append(f"{pad}{key}: [{', '.join(_dump_scalar(v) for v in value)}]\n")
        else:
            out.append(f"{pad}{key}: {_dump_scalar(value)}\n")
    return "".join(out)


# ------------------------------------------------------------------- the config

def _from_dict(cls, data: Dict[str, Any]):
    if not dataclasses.is_dataclass(cls):
        return data
    hints = typing.get_type_hints(cls)
    kwargs = {}
    field_names = {f.name for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in field_names:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        ftype = hints.get(key)
        if isinstance(ftype, type) and dataclasses.is_dataclass(ftype):
            kwargs[key] = _from_dict(ftype, value)
        elif isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def load_config(path: Optional[str] = None, overrides: Sequence[str] = ()) -> Config:
    """Load a YAML config file merged over the defaults, then apply ``key.path=value``
    overrides."""
    data: Dict[str, Any] = {}
    if path:
        with open(path) as f:
            data = parse_yaml(f.read()) or {}
    cfg = _from_dict(Config, data)
    return apply_overrides(cfg, overrides)


def _parse_value(s: str) -> Any:
    """An override's value, read as a YAML value of the subset; a string that Python
    reads as a number is that number, as in the JAX package."""
    value = _value(s, 1) if s.strip() else None
    if isinstance(value, str):
        for number in (int, float):
            try:
                return number(value)
            except ValueError:
                pass
    return value


def apply_overrides(cfg: Config, overrides: Sequence[str]) -> Config:
    """Apply ``a.b.c=value`` overrides (values read as YAML of the subset)."""
    for item in overrides:
        if "=" not in item:
            raise ValueError(f"override must look like key.path=value: {item!r}")
        path, raw = item.split("=", 1)
        keys = path.split(".")
        value = _parse_value(raw)
        if isinstance(value, list):
            value = tuple(value)

        def rebuild(node, keys):
            if len(keys) == 1:
                if not hasattr(node, keys[0]):
                    raise KeyError(f"unknown config key: {path}")
                return dataclasses.replace(node, **{keys[0]: value})
            child = getattr(node, keys[0])
            return dataclasses.replace(node, **{keys[0]: rebuild(child, keys[1:])})

        cfg = rebuild(cfg, keys)
    return cfg


def to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def save_config(cfg: Config, path: str) -> None:
    with open(path, "w") as f:
        f.write(dump_yaml(dataclasses.asdict(cfg)))
