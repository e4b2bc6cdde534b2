"""The port's config against the JAX package's: the same dataclasses from every shipped
config file and from overrides, its YAML-subset reader against ``yaml.safe_load``, and
``save_config``'s output read back by PyYAML."""

import dataclasses
import glob
import math
import os

import pytest
import yaml

from pcdiff.core import config as jcfg
from pcdiff_torch.core import config as tcfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def _listed(d):
    """asdict with tuples as lists, as YAML gives them back."""
    if isinstance(d, dict):
        return {k: _listed(v) for k, v in d.items()}
    if isinstance(d, (list, tuple)):
        return [_listed(v) for v in d]
    return d


def test_there_are_configs():
    assert len(CONFIGS) >= 6


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_reader_equals_safe_load(path):
    text = open(path).read()
    assert tcfg.parse_yaml(text) == (yaml.safe_load(text) or {})


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_load_config_equals_jax(path):
    got, want = tcfg.load_config(path), jcfg.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert isinstance(got.model.active_modalities, tuple)


OVERRIDES = [
    ["train.lr=1e-4", "sample.sigma_min=2.5e-3", "train.weight_decay=0.0"],
    ["model.active_modalities=[class, view]", "model.active_modalities=[depth]"],
    ["train.continue_training=true", "wandb.enabled=True", "train.save_full_state=false",
     "train.device_data=off", "train.bootstrap_include_partial_pcd=yes"],
    ["train.output_dir=/tmp/a run/x", "data.h5_path=./data/train_1024.npz",
     "train.load_checkpoint_path=", "sample.load_checkpoint_path=''"],
    ["train.epochs=3", "train.seed=-7", "sample.guidance_scale=inf", "model.x_dim=+64"],
    ["model.compute_dtype=bfloat16", "sample.sampler=heun_reuse", "train.lr=1.0e4",
     "sample.s_churn=.5", "train.lr=5"],
]


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: o[0])
def test_overrides_equal_jax(overrides):
    base = os.path.join(ROOT, "configs", "modelnet.yaml")
    got = dataclasses.asdict(tcfg.load_config(base, overrides))
    want = dataclasses.asdict(jcfg.load_config(base, overrides))
    assert got == want


def test_override_errors_match():
    for cfg in (tcfg, jcfg):
        with pytest.raises(ValueError):
            cfg.load_config(None, ["train.lr"])
        with pytest.raises(KeyError):
            cfg.load_config(None, ["train.no_such_key=1"])


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_save_config_reads_back(path, tmp_path):
    cfg = tcfg.load_config(path, ["train.lr=1e-06", "sample.sigma_max=inf"])
    # strings that would read back as another type, or not at all, unless quoted
    cfg = dataclasses.replace(
        cfg, train=dataclasses.replace(cfg.train, output_dir="off"),
        data=dataclasses.replace(cfg.data, h5_path="0755"),
        wandb=dataclasses.replace(cfg.wandb, project="it's: a # test"))
    out = tmp_path / "cfg.yaml"
    tcfg.save_config(cfg, str(out))
    back = yaml.safe_load(out.read_text())
    assert back == _listed(dataclasses.asdict(cfg))
    assert tcfg.parse_yaml(out.read_text()) == back
    assert tcfg.load_config(str(out)) == cfg


def test_save_config_matches_jax_save(tmp_path):
    cfg = jcfg.load_config(os.path.join(ROOT, "configs", "flagship_shapes.yaml"))
    jcfg.save_config(cfg, str(tmp_path / "j.yaml"))
    tcfg.save_config(tcfg.load_config(os.path.join(ROOT, "configs", "flagship_shapes.yaml")),
                     str(tmp_path / "t.yaml"))
    assert yaml.safe_load((tmp_path / "t.yaml").read_text()) == \
        yaml.safe_load((tmp_path / "j.yaml").read_text())


def test_floats_without_a_dot():
    assert tcfg.parse_yaml("a: 1e-4\nb: 3.0e-4\nc: -2E+3\nd: .5\ne: 1.\n") == \
        dict(a=1e-4, b=3e-4, c=-2000.0, d=0.5, e=1.0)
    nan = tcfg.parse_yaml("x: .nan\n")["x"]
    assert math.isnan(nan)


def test_comments_quotes_and_nesting():
    text = ("# top\nouter:   # trailing\n  inner:\n    k: 'a # b'  # c\n    q: \"x\\ty\"\n"
            "  l: [a, 'b, c', 3, 2.5, true, null]\n  e: []\nlast: ~\nplain: a#b\n")
    assert tcfg.parse_yaml(text) == yaml.safe_load(text)


BAD = [
    ("a:\n  - x\n", 2), ("a: {b: 1}\n", 1), ("a: &anchor 1\n", 1), ("a: *anchor\n", 1),
    ("a: !!str 1\n", 1), ("a: |\n  x\n", 1), ("a: >\n  x\n", 1), ("---\na: 1\n", 1),
    ("a: 1\n\tb: 2\n", 2), ("a: 0755\n", 1), ("a: 0x1F\n", 1), ("a: 12:30\n", 1),
    ("a: 1\na: 2\n", 2), ("a: [1, [2]]\n", 1), ("a:\n  b: 1\n c: 2\n", 3),
    ("a: 'open\n", 1), ("a: [1, 2\n", 1), ("- x\n", 1), ("a b: 1\n", 1),
    ("a:\n  multi line\n", 2),
]


@pytest.mark.parametrize("text,line", BAD, ids=[b[0][:12] for b in BAD])
def test_outside_the_subset_raises_with_its_line(text, line):
    with pytest.raises(tcfg.ConfigSyntaxError) as e:
        tcfg.parse_yaml(text)
    assert e.value.line == line and f"line {line}" in str(e.value)
