"""The port's bf16 loss and gradients against the JAX package's (CPU).

The tiny ``TwoStreamDenoiser`` with class and view conditioning (the backbone's every
LN -> projection site; the two-modality model keeps the one JAX compile near ten seconds,
as in ``tests/test_torch_port_attention_hook.py``) runs in bf16 on both sides
(``configs/modelnet_fast.yaml``'s compute dtype) with the same weights (through
``params_from_flax``), batch, t, noise and self-conditioning coin, and with dropout and CFG
dropout off on both sides, as ``tests/test_torch_port_train.py`` holds the fp32 step; the JAX
package's fp32 loss and gradients give the exact function both approximate. One jitted JAX program computes the
bf16 and fp32 loss and gradients together. They are compared as ``tests/test_torch_port_bf16.py``
compares the bf16 forward, at a tolerance drawn from the JAX package's own bf16 error,
``gap = relL2(JAX bf16, JAX fp32)``, over the loss terms and over the whole gradient tree:

- the port's bf16 values stand within 1.5 gap of the JAX package's fp32 ones;
- the port's and the JAX package's bf16 values stand within 2 gap of each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pcdiff.diffusion import diffusion_from_betas as jdiffusion
from pcdiff.models import attention as jattn
from pcdiff.models.two_stream import TwoStreamDenoiser as JTwoStream
from pcdiff_torch.core import flax_from_params, params_from_flax
from pcdiff_torch.data import synthetic_batch
from pcdiff_torch.diffusion import diffusion_from_betas
from pcdiff_torch.models import attention as tattn
from pcdiff_torch.models.two_stream import TwoStreamDenoiser as TTwoStream
from pcdiff_torch.train import make_loss_fn

from .test_torch_port_train import B, TINY, _jax_loss, _params

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores

GRAD_TINY = dict(TINY, active_modalities=("class", "view"))


@pytest.fixture(scope="module")
def grads():
    """(JAX fp32, JAX bf16, port bf16): each a dict of the loss terms and the flat gradient
    tree, at one draw of t, noise and a self-conditioned coin."""
    jattn.set_ln_dense_fusion("on")
    rng = np.random.default_rng(5)
    batch = synthetic_batch(rng, B, 32, 4, 32)
    diff = jdiffusion("linear", 1000)
    mods = {dt: JTwoStream(**GRAD_TINY, cond_drop_prob=0.0, dtype=dt)
            for dt in (jnp.float32, jnp.bfloat16)}
    params = _params(mods[jnp.float32], rng, batch["target"], np.zeros(B, np.int32),
                     batch["class_labels"], batch["viewpoints"], batch["partial_pcd"],
                     batch["depth_maps"])
    t = rng.integers(0, diff.num_timesteps, B).astype(np.int32)
    noise = rng.standard_normal(batch["target"].shape).astype(np.float32)

    @jax.jit
    def both(params, jbatch, t, noise):
        return {str(jnp.dtype(dt)): jax.value_and_grad(_jax_loss(m, diff, True), has_aux=True)(
            params, jbatch, t, noise, jnp.asarray(True)) for dt, m in mods.items()}

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = jax.device_get(both(params, jbatch, jnp.asarray(t), jnp.asarray(noise)))
    jattn.set_ln_dense_fusion("auto")
    res = {}
    for name, ((_, terms), g) in out.items():
        res["jax " + name] = (np.array([float(terms["mse"]), float(terms["c_dist"])]),
                              traverse_util.flatten_dict(g))

    tmod = TTwoStream(**GRAD_TINY, cond_drop_prob=0.0, dtype=torch.bfloat16, device="cpu")
    tmod.load_state_dict(params_from_flax(params), strict=True)
    loss_fn = make_loss_fn(tmod, diffusion_from_betas("linear", 1000))
    tmod.train()
    for m in tmod.active_modalities:  # encoders deterministic, as on the JAX side
        getattr(tmod, f"encoders_{m}").eval()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    with tattn.dropout_generator(torch.Generator().manual_seed(0)):
        loss, terms = loss_fn(tbatch, torch.from_numpy(t).long(), torch.from_numpy(noise),
                              True, True)
    loss.backward()
    assert terms["self_conditioned"] == 1.0
    g = traverse_util.flatten_dict(flax_from_params(
        tmod, {n: p.grad.float() for n, p in tmod.named_parameters()}))
    res["port bfloat16"] = (np.array([terms["mse"].item(), terms["c_dist"].item()]),
                            {k: np.asarray(v, np.float32) for k, v in g.items()})
    return res


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _flat(tree, paths):
    return np.concatenate([np.ravel(tree[p]).astype(np.float64) for p in paths])


@pytest.mark.parametrize("what", ["loss terms", "gradient tree"])
def test_bf16_loss_and_gradients_match_jax_bf16(grads, what):
    j32, jb, port = grads["jax float32"], grads["jax bfloat16"], grads["port bfloat16"]
    if what == "loss terms":
        a, b, c = port[0], jb[0], j32[0]
    else:
        paths = sorted(j32[1])
        assert set(port[1]) == set(paths) == set(jb[1])
        a, b, c = _flat(port[1], paths), _flat(jb[1], paths), _flat(j32[1], paths)
    gap = _rel(b, c)
    assert 0 < gap < 1e-1, (what, gap)  # bf16 rounding, not a broken graph
    assert _rel(a, c) <= 1.5 * gap, (what, _rel(a, c), gap)
    assert _rel(a, b) <= 2.0 * gap, (what, _rel(a, b), gap)
