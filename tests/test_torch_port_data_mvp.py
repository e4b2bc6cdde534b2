"""The port's MVP and ShapeNet-multimodal datasets and its file audit against the JAX
package's, on the JAX package's H5 fixtures and on their ``.npz`` twins.

- The port's fixture builders make the JAX builders' arrays from the same seed.
- Items are bit-equal under the same numpy ``rng``; MVP's FPS-cached arrays are
  index-exact (the native host FPS, and the port's own FPS without it).
- The audit reports are equal, on a clean fixture and on one with a broken instance.
- ``cli.train.build_dataset`` takes both names, and MVP's labels past a smaller class table
  give the NaN rows that flax's ``nn.Embed`` gives.
No jitted JAX program runs here: the JAX package's data modules are numpy (its MVP cache
takes the same native host FPS).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pcdiff.data import MultiModalCompletion as JMultiModal
from pcdiff.data import MVPCompletion as JMVP
from pcdiff.data import make_modelnet_fixture as j_modelnet_fixture
from pcdiff.data import make_multimodal_fixture as j_multimodal_fixture
from pcdiff.data import make_mvp_fixture as j_mvp_fixture
from pcdiff.data.qa import audit_modelnet_h5 as j_audit
from pcdiff_torch.cli.train import build_dataset
from pcdiff_torch.core.config import load_config
from pcdiff_torch.data import (
    MultiModalCompletion,
    MVPCompletion,
    audit_modelnet_h5,
    h5_to_npz,
    make_multimodal_fixture,
    make_mvp_fixture,
)
from pcdiff_torch.data import mvp as tmvp
from pcdiff_torch.data.modelnet import open_dataset

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores


def _tree(path):
    """Every dataset and group attribute of a store: {name: array}."""
    store = open_dataset(path)
    out = {}

    def walk(group):
        for k in store.keys(group):
            name = f"{group}/{k}" if group else k
            try:
                children = store.keys(name)
            except AttributeError:  # an h5py dataset has no keys
                children = []
            if children:
                walk(name)
            else:
                out[name] = store.read(name)
        if group and store.attr(group, "label") is not None:
            out[f"{group}@label"] = store.attr(group, "label")

    walk("")
    store.close()
    return out


def _equal_trees(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]) and np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("mvp_mm")
    out = {}
    out["mvp.h5"] = j_mvp_fixture(str(root / "mvp.h5"), num_points=128)
    out["mm.h5"] = j_multimodal_fixture(str(root / "mm.h5"))
    for name in ("mvp", "mm"):
        out[f"{name}.npz"] = h5_to_npz(out[f"{name}.h5"], str(root / f"{name}.npz"))
    out["port_mvp.npz"] = make_mvp_fixture(str(root / "port_mvp.npz"), num_points=128)
    out["port_mm.npz"] = make_multimodal_fixture(str(root / "port_mm.npz"))
    out["port_mvp.h5"] = make_mvp_fixture(str(root / "port_mvp.h5"), num_points=128)
    out["port_mm.h5"] = make_multimodal_fixture(str(root / "port_mm.h5"))
    out["root"] = root
    return out


@pytest.mark.parametrize("name", ["mvp", "mm"])
@pytest.mark.parametrize("fmt", ["npz", "h5"])
def test_fixture_builders_match_jax(files, name, fmt):
    _equal_trees(_tree(files[f"port_{name}.{fmt}"]), _tree(files[f"{name}.h5"]))


def _items_equal(got_ds, want_ds, indices, seed=5):
    g, w = np.random.default_rng(seed), np.random.default_rng(seed)
    for i in indices:
        got, want = got_ds.__getitem__(i, rng=g), want_ds.__getitem__(i, rng=w)
        assert got.keys() == want.keys()
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            assert np.array_equal(got[k], want[k]), (i, k)


@pytest.mark.parametrize("fmt", ["h5", "npz"])
@pytest.mark.parametrize("n_samples", [None, 32])
@pytest.mark.parametrize("prefix", ["train", "test"])
def test_mvp_items_bit_equal(files, fmt, n_samples, prefix):
    want = JMVP(files["mvp.h5"], prefix=prefix, n_samples=n_samples)
    got = MVPCompletion(files[f"mvp.{fmt}"], prefix=prefix, n_samples=n_samples)
    assert len(got) == len(want) == 52
    assert np.array_equal(got.input_data, want.input_data)
    assert got.input_data.dtype == want.input_data.dtype
    if prefix == "train":
        assert np.array_equal(got.gt_data, want.gt_data) and np.array_equal(got.labels,
                                                                            want.labels)
    _items_equal(got, want, [0, 25, 26, 51, 7])


def test_mvp_fps_cache_is_index_exact_without_the_native_build(files, monkeypatch):
    pts = np.asarray(MVPCompletion(files["mvp.npz"]).input_data[:40], dtype=np.float32)
    native = tmvp.fps_downsample(pts, 16, batch=16)
    monkeypatch.setattr("pcdiff_torch.geometry.fps_native.native_fps_indices",
                        lambda *a, **k: None)
    assert np.array_equal(tmvp.fps_downsample(pts, 16, batch=16), native)
    # the starts restart every chunk: element b starts at index b % 16
    assert np.array_equal(native[:, 0], pts[np.arange(40), np.arange(40) % 16])


def test_mvp_limit_and_prefix(files):
    ds = MVPCompletion(files["mvp.npz"], limit=30)
    assert len(ds) == 30 and ds.gt_data.shape[0] == 2
    with pytest.raises(ValueError):
        MVPCompletion(files["mvp.npz"], prefix="bogus")


@pytest.mark.parametrize("fmt", ["h5", "npz"])
@pytest.mark.parametrize("case", ["fixed", "recompute", "skip"])
def test_multimodal_items_bit_equal(files, fmt, case):
    kw = dict(num_scans=8, scans_per_object=4)
    if case == "recompute":
        kw.update(depth_min=None, depth_max=None, viewpoints_max_abs=None)
    if case == "skip":
        kw.update(skip_list=[("car", "car_0")])
    want = JMultiModal(files["mm.h5"], **kw)
    got = MultiModalCompletion(files[f"mm.{fmt}"], **kw)
    assert got.index == want.index and len(got) == (4 if case == "skip" else 8)
    assert (got.depth_min, got.depth_max, got.viewpoints_max_abs) == (
        want.depth_min, want.depth_max, want.viewpoints_max_abs)
    _items_equal(got, want, range(len(want)))
    item = got.__getitem__(0, rng=np.random.default_rng(0))
    assert item["class_labels"] == 3 and item["depth_maps"].shape == (32, 32, 1)
    got.close()
    want.close()


def test_multimodal_reopens_the_file_per_item(files):
    kw = dict(num_scans=8, scans_per_object=4)
    _items_equal(MultiModalCompletion(files["mm.npz"], keep_h5_open=False, **kw),
                 JMultiModal(files["mm.h5"], keep_h5_open=False, **kw), [0, 5])


@pytest.fixture(scope="module")
def modelnet_files(files):
    import h5py

    root = files["root"]
    clean = j_modelnet_fixture(str(root / "clean.h5"))
    broken = j_modelnet_fixture(str(root / "broken.h5"))
    with h5py.File(broken, "a") as f:  # as tests/test_aux.py breaks it
        del f["airplane"]["airplane_0000"]["partials"]["scan_0001"]["pointcloud"]
        del f["bench"]["bench_0001"]["ground_truth"]
    return {name: (path, h5_to_npz(path, str(root / f"{name}.npz")))
            for name, path in (("clean", clean), ("broken", broken))}


@pytest.mark.parametrize("name", ["clean", "broken"])
@pytest.mark.parametrize("kw", [dict(expected_points=64, expected_scans=3),
                                dict(expected_points=32, max_instances_per_class=1)],
                         ids=["expected", "bad_shapes"])
def test_audit_reports_equal(modelnet_files, name, kw):
    h5, npz = modelnet_files[name]
    want = j_audit(h5, **kw)
    for path in (h5, npz):
        got = audit_modelnet_h5(path, **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)  # two classes: by field
        assert got.ok() == want.ok() == (name == "clean" and "max_instances_per_class" not in kw)


def test_build_dataset_takes_both_names(files):
    root = files["root"]
    mm = make_multimodal_fixture(str(root / "mm154.npz"), num_scans=154)
    cfg = load_config(None, ["data.dataset=mvp", f"data.h5_path={files['mvp.npz']}",
                             "model.num_points=32"])
    mvp = build_dataset(cfg)
    assert isinstance(mvp, MVPCompletion) and mvp.input_data.shape == (52, 32, 3)
    cfg = load_config(None, ["data.dataset=multimodal", f"data.h5_path={mm}"])
    ds = build_dataset(cfg)
    assert isinstance(ds, MultiModalCompletion) and len(ds) == 80
    assert ds.index[-1] == ("car", "car_1", 153)


def test_labels_past_the_class_table_give_nan_rows_as_flax():
    """MVP's labels run 1-16: with a smaller table (configs/modelnet.yaml's 10 classes) the
    port's ``Embed`` gives what flax's ``nn.Embed`` gives (``jnp.take``'s fill mode): NaN rows
    past the table, negative indices counted from the end."""
    import flax.linen as fnn

    from pcdiff_torch.models.encoders import Embed

    ids = np.array([9, 10, 16, -1, -10, -11, 0], np.int32)
    table = np.random.default_rng(0).standard_normal((10, 4)).astype(np.float32)
    want = np.asarray(fnn.Embed(10, 4).apply({"params": {"embedding": table}}, ids))
    emb = Embed(10, 4, device="cpu")
    emb.weight.data = torch.from_numpy(table)
    got = emb(torch.from_numpy(ids)).detach().numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(want[[1, 2, 5]]).all()
    np.testing.assert_array_equal(got[~np.isnan(want)], want[~np.isnan(want)])
