"""The profiling ladder of the multi-head attention kernel (K8) on the CPU.

- Each rung of ``_torch_ladder`` against the TPU ladder kernel (``_ladder_kernel`` of
  ``scripts/attn_profile.py``, loaded by path, run in interpret mode) at the TPU script's
  tiny check shape, ragged both ways.
- The entry point (``python -m pcdiff_torch.scripts.attn_profile``) with ``--device cpu``
  prints one line per rung.
- The card's bound at the flagship z shape against a count by hand.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pcdiff_torch.ops import attn_ladder as al
from pcdiff_torch.scripts import attn_profile

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores


@pytest.fixture(scope="module")
def tpu_script():
    spec = importlib.util.spec_from_file_location("tpu_attn_profile",
                                                  ROOT / "scripts" / "attn_profile.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rung", al.RUNGS)
def test_ladder_rung_matches_tpu_kernel(tpu_script, rung):
    b, nq, nk, heads, hd = attn_profile.CPU_SHAPE
    q, k, v = attn_profile.inputs(b, nq, nk, hd, "cpu")
    with pltpu.force_tpu_interpret_mode():
        want = tpu_script._make_pallas(rung, b, nq, nk, heads, hd)(
            *(jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)))
    got = al.ladder(q, k, v, heads, rung)
    assert got.dtype == torch.bfloat16 and got.shape == (b, nq, hd)
    want = np.asarray(want, np.float32)
    # bf16 operands and fp32 scores on both sides: a summation-order difference can flip the
    # bf16 rounding of an output (2^-7 relative) or, in nomax, of one exponential
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-3 * np.abs(want).max())
    assert al.launches == 0  # no kernel on a CPU tensor


def test_cpu_entry_point_prints_every_rung(capsys):
    attn_profile.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    for rung in al.RUNGS:
        assert sum(line.split()[0] == rung for line in lines) == 1, rung
    assert "no device time" in lines[0] and "grid2: no counterpart" in lines[-1]


def test_card_bound_by_hand():
    clock = 1.98e9
    scores = 64 * 8 * 643 * 643  # rows x heads x Nq x Nk at the z shape
    assert scores == 211_685_888
    tensor = 2 * 2 * scores * 32 / 989e12  # Q K^T and P V, 2 flops a multiply-add
    sfu = scores / (16 * 132 * clock)  # one exponential a score
    fp32 = 3 * scores / (128 * 132 * clock)  # max, subtract, add
    memory = 2 * 64 * 256 * (643 * 4) / 3.35e12  # bf16 q, k, v, o once
    full = attn_profile.card_bound("full", 64, 643, 643, 8, 256, clock)
    for unit, want in (("tensor", tensor), ("sfu", sfu), ("fp32", fp32), ("memory", memory)):
        assert full[unit] == pytest.approx(1e3 * want, rel=1e-12), unit
    assert full["bound_by"] == "sfu" and full["bound_ms"] == pytest.approx(1e3 * sfu)
    # qk's output, the first D key columns of S, reads q and only the first D key rows of k
    qk = attn_profile.card_bound("qk", 64, 643, 643, 8, 256, clock)
    qk_memory = 2 * 64 * 256 * (643 * 2 + 32) / 3.35e12
    assert (qk["tensor"], qk["sfu"], qk["fp32"], qk["memory"]) == pytest.approx(
        (1e3 * tensor / 2, 0, 0, 1e3 * qk_memory), rel=1e-12)
    assert qk["bound_by"] == "tensor"  # all of S takes longer than q, o and D rows of k move
    # the softmax rungs before PV read q and k, not v
    for rung in ("qk_max", "qk_exp", "qk_sum"):
        b = attn_profile.card_bound(rung, 64, 643, 643, 8, 256, clock)
        assert b["memory"] == pytest.approx(1e3 * 2 * 64 * 256 * (643 * 3) / 3.35e12), rung
    assert attn_profile.card_bound("qk_max", 64, 643, 643, 8, 256, clock)["bound_by"] == "memory"
    assert attn_profile.card_bound("nomax", 64, 643, 643, 8, 256, clock)["memory"] == \
        pytest.approx(1e3 * memory)
