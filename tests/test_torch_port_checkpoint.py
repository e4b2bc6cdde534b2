"""The port's checkpoints: a full train state and a bare parameter set saved and restored
bit for bit; and the reference ``.pt`` mapping against the JAX package's, both ways."""

import os

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from pcdiff.core import checkpoint as jckpt
from pcdiff.models.two_stream import TwoStreamDenoiser as JTwoStream
from pcdiff_torch.core import checkpoint as tckpt
from pcdiff_torch.core import init_params, params_from_flax
from pcdiff_torch.diffusion import diffusion_from_betas
from pcdiff_torch.models.two_stream import TwoStreamDenoiser as TTwoStream
from pcdiff_torch.train import create_train_state, ema_update, init_ema, make_train_step

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores

TINY = dict(num_points=16, num_latents=4, latent_dim=32, x_dim=32, num_blocks=2,
            num_compute_layers=2, num_heads=4, num_classes=10, num_tokens_ppcd=4,
            num_tokens_depth=4, depth_image_size=32, depth_patch=16)


@pytest.fixture(scope="module")
def flax_tree():
    """The JAX model's parameter tree, traced with eval_shape and filled from numpy."""
    b = 1
    args = (np.zeros((b, 16, 3), np.float32), np.zeros(b, np.int32), np.zeros(b, np.int32),
            np.zeros((b, 3), np.float32), np.zeros((b, 4, 3), np.float32),
            np.zeros((b, 32, 32, 1), np.float32))
    shapes = jax.eval_shape(JTwoStream(**TINY).init, jax.random.PRNGKey(0), *args)
    rng = np.random.default_rng(0)
    flat = {p: rng.standard_normal(sd.shape).astype(np.float32)
            for p, sd in traverse_util.flatten_dict(shapes["params"]).items()}
    return {"params": traverse_util.unflatten_dict(flat)}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"target": rng.uniform(-0.5, 0.5, (2, 16, 3)).astype(np.float32),
            "class_labels": np.array([1, 2]),
            "viewpoints": rng.standard_normal((2, 3)).astype(np.float32),
            "partial_pcd": rng.uniform(-0.5, 0.5, (2, 16, 3)).astype(np.float32),
            "depth_maps": rng.random((2, 32, 32, 1)).astype(np.float32)}


def _trained(seed):
    """A tiny model after two AdamW steps, its EMA and the step generator."""
    gen = torch.Generator().manual_seed(seed)
    model = init_params(TTwoStream(**TINY, device="cpu"), gen)
    state = create_train_state(model, total_steps=10, device="cpu")
    step = make_train_step(model, diffusion_from_betas(), device="cpu")
    ema = init_ema(model)
    for i in range(2):
        step(state, _batch(i), gen, True)
        ema_update(ema, model, 0.9)
    return state, ema, gen


def _fresh(seed=99):
    model = init_params(TTwoStream(**TINY, device="cpu"), torch.Generator().manual_seed(seed))
    return create_train_state(model, total_steps=10, device="cpu"), init_ema(model)


def _assert_states_equal(a, b):
    assert a.step == b.step
    for p, q in zip(a.params, b.params, strict=True):
        assert torch.equal(p, q)
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(sa["state"][i][k], sb["state"][i][k])


def test_train_state_round_trip_is_bit_equal(tmp_path):
    state, ema, gen = _trained(0)
    d = str(tmp_path / "checkpoints")
    tckpt.save_checkpoint(d, 2, state, generator=gen, epoch=1)
    tckpt.save_checkpoint(str(tmp_path / "ema"), 2, ema, epoch=1)
    assert sorted(os.listdir(d)) == ["2"]
    assert tckpt.latest_checkpoint_step(d) == 2
    assert tckpt.checkpoint_meta(d) == {"step": 2, "kind": "train_state", "epoch": 1}

    new, new_ema = _fresh()
    new_gen = torch.Generator().manual_seed(1234)
    torch.manual_seed(4321)
    restored, step = tckpt.restore_checkpoint(d, new, generator=new_gen)
    assert restored is new and step == 2
    _assert_states_equal(state, new)
    assert torch.equal(new_gen.get_state(), gen.get_state())
    cpu_rng = torch.get_rng_state()
    assert torch.equal(cpu_rng, torch.load(os.path.join(d, "2", "state.pt"),
                                           weights_only=True)["generators"]["cpu"])
    restored_ema, _ = tckpt.restore_checkpoint(str(tmp_path / "ema"), new_ema)
    assert restored_ema is new_ema and new_ema.keys() == ema.keys()
    assert all(torch.equal(new_ema[k], ema[k]) for k in ema)
    # the next update from the restored state equals the next update from the saved one
    step_a = make_train_step(state.model, diffusion_from_betas(), device="cpu")
    step_b = make_train_step(new.model, diffusion_from_betas(), device="cpu")
    ma, mb = step_a(state, _batch(5), gen, True), step_b(new, _batch(5), new_gen, True)
    assert torch.equal(ma["loss"], mb["loss"])
    _assert_states_equal(state, new)


def test_bare_parameters_and_weights(tmp_path):
    state, ema, gen = _trained(1)
    d, e = str(tmp_path / "c"), str(tmp_path / "ema")
    tckpt.save_checkpoint(d, 5, state, generator=gen, epoch=2)
    tckpt.save_checkpoint(e, 5, ema)
    assert tckpt.checkpoint_meta(e)["kind"] == "params"
    # a module or a mapping takes the parameters of either kind
    for src, want in ((d, dict(state.model.named_parameters())), (e, ema)):
        model = TTwoStream(**TINY, device="cpu")
        tckpt.restore_checkpoint(src, model)
        assert all(torch.equal(p, want[n]) for n, p in model.named_parameters())
        weights = tckpt.load_weights(src)
        assert weights.keys() == want.keys()
        assert all(torch.equal(weights[n], want[n]) for n in want)
    with pytest.raises(ValueError, match="not a train state"):
        tckpt.restore_checkpoint(e, _fresh()[0])
    with pytest.raises(KeyError):
        tckpt.restore_checkpoint(e, {"not.a.parameter": torch.zeros(1)})
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "nothing"), ema)
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(d, ema, step=4)


def test_steps_replace_and_max_to_keep(tmp_path):
    _, ema, _ = _trained(2)
    d = str(tmp_path / "c")
    for s in (1, 2, 3):
        tckpt.save_checkpoint(d, s, ema, epoch=s)
    tckpt.save_checkpoint(d, 3, ema, epoch=7)  # the same step again replaces it
    assert tckpt.checkpoint_meta(d, 3)["epoch"] == 7 and tckpt.latest_checkpoint_step(d) == 3
    tckpt.save_checkpoint(d, 4, ema, max_to_keep=2)
    assert sorted(os.listdir(d)) == ["3", "4"]
    assert tckpt.latest_checkpoint_step(str(tmp_path / "none")) is None


def test_reference_import_equals_params_from_flax(flax_tree, tmp_path):
    ref_sd = jckpt.export_two_stream_torch_state(flax_tree)
    got = tckpt.import_two_stream_torch_state(ref_sd)
    want = params_from_flax(flax_tree)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    # the same through a .pt file of torch tensors, as the reference saves them
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in ref_sd.items()},
               str(tmp_path / "ref.pt"))
    loaded = tckpt.load_torch_checkpoint(str(tmp_path / "ref.pt"))
    assert all(torch.equal(loaded[k], want[k]) for k in want)
    weights = tckpt.load_weights(str(tmp_path / "ref.pt"))
    assert all(torch.equal(weights[k], want[k]) for k in want)
    # the port's flax-shaped tree is the JAX package's
    tree = tckpt.flax_tree_from_torch_state(ref_sd)
    jtree = jckpt.import_two_stream_torch_state(ref_sd)
    flat, jflat = (traverse_util.flatten_dict(t) for t in (tree, jtree))
    assert flat.keys() == jflat.keys()
    assert all(np.array_equal(flat[k], jflat[k]) for k in jflat)


def test_export_equals_jax(flax_tree):
    model = TTwoStream(**TINY, device="cpu")
    model.load_state_dict(params_from_flax(flax_tree))
    got = tckpt.export_two_stream_torch_state(model)
    want = jckpt.export_two_stream_torch_state(flax_tree)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], np.asarray(want[k])), k
    # and back: import(export(model)) is the model's own state
    back = tckpt.import_two_stream_torch_state(got)
    assert all(torch.equal(back[k], v) for k, v in model.state_dict().items())
