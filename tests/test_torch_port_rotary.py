"""The port's rotary partial-cloud encoder against the JAX package's, on the CPU in fp32.

The encoder at 2 layers and width 64 (4 heads of 16; 48 points, 16 tokens), random
parameters of the JAX tree's shapes carried by ``params_from_flax``, one jitted JAX
forward: rel L2 <= 1e-5 (fp32 on both sides; only summation orders differ). Also the
rotary embedding alone, both modules' head-dim assertion, and the parameter tree mapped
one to one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pcdiff.models import rotary as jrot
from pcdiff_torch.core import flax_from_params, params_from_flax
from pcdiff_torch.models import rotary as trot

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores

CFG = dict(embed_dim=64, num_tokens=16, num_layers=2, num_heads=4)
REL = 1e-5


def _rel(got, want):
    return float(np.linalg.norm(np.asarray(got) - np.asarray(want)) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def encoders():
    rng = np.random.default_rng(4)
    pcd = rng.uniform(-0.5, 0.5, (2, 48, 3)).astype(np.float32)
    jmod = jrot.RotaryPartialPointCloudEncoder(**CFG)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), pcd)["params"]
    flat = {}
    for path, sd in traverse_util.flatten_dict(shapes).items():
        z = rng.standard_normal(sd.shape).astype(np.float32)
        if path[-1] == "kernel":
            flat[path] = z / np.sqrt(sd.shape[0])
        elif path[-1] == "scale":
            flat[path] = 1.0 + 0.1 * z
        else:
            flat[path] = 0.1 * z if path[-1] == "bias" else 0.5 * z
    params = traverse_util.unflatten_dict({k: v.astype(np.float32) for k, v in flat.items()})
    want = np.asarray(jax.jit(jmod.apply)({"params": params}, pcd))
    tmod = trot.RotaryPartialPointCloudEncoder(**CFG, device="cpu")
    tmod.load_state_dict(params_from_flax(params), strict=True)
    return params, tmod, pcd, want


def test_encoder_matches_jax(encoders):
    _, tmod, pcd, want = encoders
    with torch.no_grad():
        got = tmod(torch.from_numpy(pcd)).numpy()
    assert got.shape == want.shape == (2, CFG["num_tokens"], CFG["embed_dim"])
    assert _rel(got, want) <= REL


def test_parameter_tree_maps_one_to_one(encoders):
    params, tmod, _, _ = encoders
    got = traverse_util.flatten_dict(flax_from_params(tmod))
    want = traverse_util.flatten_dict(params)
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_rotary_embedding_matches_jax():
    rng = np.random.default_rng(1)
    q, k = (rng.standard_normal((2, 3, 5, 8)).astype(np.float32) for _ in range(2))
    coords = rng.uniform(-1, 1, (2, 5, 3)).astype(np.float32)
    jq, jk = jrot.apply_rotary_pos_emb(jnp.asarray(q), jnp.asarray(k), jnp.asarray(coords))
    tq, tk = trot.apply_rotary_pos_emb(*(torch.from_numpy(a) for a in (q, k, coords)))
    for got, want in ((tq, jq), (tk, jk)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
        # dims past the first 6 are untouched
        assert np.array_equal(got.numpy()[..., 6:], np.asarray(want)[..., 6:])
    # a bf16 q comes out in fp32, as jnp promotes bf16 * fp32
    bq, _ = trot.apply_rotary_pos_emb(torch.from_numpy(q).bfloat16(), torch.from_numpy(k),
                                      torch.from_numpy(coords))
    assert bq.dtype == torch.float32


@pytest.mark.parametrize("dim,heads", [(20, 4), (28, 4)], ids=["head_dim_5", "head_dim_7"])
def test_head_dim_assertion(dim, heads):
    x = np.zeros((1, 4, dim), np.float32)
    pos = np.zeros((1, 4, 3), np.float32)
    with pytest.raises(AssertionError, match="head dim"):
        jrot.RotarySelfAttention(dim, heads).init(jax.random.PRNGKey(0), x, pos)
    with pytest.raises(AssertionError, match="head dim"):
        trot.RotarySelfAttention(dim, heads, device="cpu")(torch.from_numpy(x),
                                                           torch.from_numpy(pos))
