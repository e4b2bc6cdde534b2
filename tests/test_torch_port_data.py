"""The port's data layer against the JAX package's: the fixture builders' arrays, the
ModelNet-completion dataset on ``.h5`` and ``.npz`` item for item, the batch loader, the
H5-to-archive conversion, and the error for an H5 file without h5py."""

import sys

import h5py
import numpy as np
import pytest

from pcdiff.data import loader as jloader
from pcdiff.data import modelnet as jmodelnet
from pcdiff.data import synthetic as jsynth
from pcdiff_torch.data import loader as tloader
from pcdiff_torch.data import modelnet as tmodelnet
from pcdiff_torch.data import synthetic as tsynth


def _h5_arrays(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, o[()]) if isinstance(o, h5py.Dataset)
                     else None)
    return out


def _npz_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


BUILDERS = [
    ("modelnet", dict(seed=3, instances_per_class=2, scans_per_instance=3, num_points=48,
                      depth_size=16)),
    ("shapes", dict(seed=5, instances_per_class=2, scans_per_instance=3, num_points=96,
                    depth_size=24)),
]


@pytest.mark.parametrize("kind,kw", BUILDERS, ids=[b[0] for b in BUILDERS])
def test_fixture_arrays_equal_jax(kind, kw, tmp_path):
    jbuild = getattr(jsynth, f"make_{kind}_fixture")
    tbuild = getattr(tsynth, f"make_{kind}_fixture")
    jbuild(str(tmp_path / "j.h5"), **kw)
    tbuild(str(tmp_path / "t.npz"), **kw)
    tbuild(str(tmp_path / "t.h5"), **kw)
    want = _h5_arrays(tmp_path / "j.h5")
    _assert_same(_npz_arrays(tmp_path / "t.npz"), want)
    _assert_same(_h5_arrays(tmp_path / "t.h5"), want)


def _schema_fixture(rng):
    """Classes in an unsorted write order, a default skip class, and an instance on the
    train split's skip list."""
    arrays = {}
    for cls, insts in (("car", ("car_0001", "car_0239", "car_0002")),
                       ("chair", ("chair_0005",)), ("airplane", ("airplane_0011",))):
        for inst in insts:
            arrays[f"{cls}/{inst}/ground_truth"] = rng.uniform(-60, 60, (40, 3)).astype(
                np.float32)
            for scan in (7, 30, 2):
                base = f"{cls}/{inst}/partials/scan_{scan:04d}"
                arrays[f"{base}/pointcloud"] = rng.uniform(-0.7, 0.7, (40, 3)).astype(
                    np.float32)
                arrays[f"{base}/distance"] = (rng.random((8, 8)) * 255).astype(np.float32)
    return arrays


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("modelnet")
    arrays = _schema_fixture(np.random.default_rng(0))
    tmodelnet.write_dataset(str(root / "s.h5"), arrays)
    tmodelnet.write_dataset(str(root / "s.npz"), arrays)
    jsynth.make_shapes_fixture(str(root / "shapes.h5"), seed=2, instances_per_class=1,
                               scans_per_instance=2, num_points=64, depth_size=16)
    tmodelnet.h5_to_npz(str(root / "shapes.h5"), str(root / "shapes.npz"))
    return root


@pytest.mark.parametrize("name", ["s", "shapes"])
@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("skip", ["default", None, ("car",)], ids=["default", "none", "car"])
@pytest.mark.parametrize("suffix", [".h5", ".npz"])
def test_dataset_items_equal_jax(datasets, name, split, skip, suffix):
    kw = {} if skip == "default" else dict(skip_classes=skip)
    j = jmodelnet.ModelNetCompletion(str(datasets / f"{name}.h5"), split=split, **kw)
    t = tmodelnet.ModelNetCompletion(str(datasets / f"{name}{suffix}"), split=split, **kw)
    assert len(t) == len(j) > 0
    assert t.class_to_label == j.class_to_label
    assert t.samples == j.samples
    for i in range(len(j)):
        a = j.__getitem__(i, rng=np.random.default_rng(i))
        b = t.__getitem__(i, rng=np.random.default_rng(i))
        assert a.keys() == b.keys()
        for k in a:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
            assert np.array_equal(a[k], b[k]), (i, k)
    j.close()
    t.close()


def test_dataset_without_keeping_the_file_open(datasets):
    j = jmodelnet.ModelNetCompletion(str(datasets / "s.h5"), keep_h5_open=False)
    t = tmodelnet.ModelNetCompletion(str(datasets / "s.npz"), keep_h5_open=False)
    for i in range(len(j)):
        a = j.__getitem__(i, rng=np.random.default_rng(7))
        b = t.__getitem__(i, rng=np.random.default_rng(7))
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_skip_lists_and_viewpoints_equal_jax():
    assert tmodelnet.DEFAULT_SKIP_CLASSES == jmodelnet.DEFAULT_SKIP_CLASSES
    assert tmodelnet.TRAIN_SKIP_INSTANCES == jmodelnet.TRAIN_SKIP_INSTANCES
    assert tsynth.SYNTHETIC_CLASSES == jsynth.SYNTHETIC_CLASSES
    a, b = tmodelnet.build_viewpoint_table(), jmodelnet.build_viewpoint_table()
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_h5_to_npz_round_trips(datasets, tmp_path):
    want = _h5_arrays(datasets / "shapes.h5")
    _assert_same(_npz_arrays(datasets / "shapes.npz"), want)
    tmodelnet.write_dataset(str(tmp_path / "back.h5"), _npz_arrays(datasets / "shapes.npz"))
    _assert_same(_h5_arrays(tmp_path / "back.h5"), want)


@pytest.mark.parametrize("suffix", [".h5", ".npz"])
def test_export_instance_ground_truths_equal_jax(datasets, tmp_path, suffix):
    j = jmodelnet.export_instance_ground_truths(
        str(datasets / "s.h5"), npz_output=str(tmp_path / "j.npz"),
        labels_output=str(tmp_path / "jl.npz"))
    t = tmodelnet.export_instance_ground_truths(
        str(datasets / f"s{suffix}"), npz_output=str(tmp_path / "t.npz"),
        labels_output=str(tmp_path / "tl.npz"))
    _assert_same(t, j)
    _assert_same(_npz_arrays(tmp_path / "t.npz"), _npz_arrays(tmp_path / "j.npz"))


def test_h5_without_h5py_raises_and_npz_does_not(datasets, monkeypatch):
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py now raises ImportError
    with pytest.raises(ImportError, match="h5_to_npz"):
        tmodelnet.ModelNetCompletion(str(datasets / "s.h5"))
    with pytest.raises(ImportError, match="h5_to_npz"):
        tsynth.make_modelnet_fixture(str(datasets / "never.h5"))
    assert len(tmodelnet.ModelNetCompletion(str(datasets / "s.npz"))) > 0


def test_unknown_suffix_raises(tmp_path):
    with pytest.raises(ValueError, match=".npz or .h5"):
        tsynth.make_modelnet_fixture(str(tmp_path / "x.hdf"))


class _Items:
    """A map-style dataset whose items depend on the index and on the rng."""

    def __len__(self):
        return 53

    def __getitem__(self, idx, rng=None):
        rng = rng or np.random.default_rng()
        return dict(x=np.full(3, idx, np.int64), r=rng.random(2))


LOADERS = [
    dict(batch_size=8), dict(batch_size=8, shuffle=False), dict(batch_size=8, drop_last=False),
    dict(batch_size=5, process_index=1, process_count=2, seed=3),
    dict(batch_size=7, shuffle=False, drop_last=False, process_index=0, process_count=3),
]


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("kw", LOADERS, ids=[str(i) for i in range(len(LOADERS))])
def test_loader_batches_equal_jax(kw, prefetch):
    j = jloader.BatchLoader(_Items(), prefetch=prefetch, **kw)
    t = tloader.BatchLoader(_Items(), prefetch=prefetch, **kw)
    assert len(t) == len(j)
    for epoch in (0, 3):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        got, want = list(t), list(j)
        assert len(got) == len(want) == len(j)
        for a, b in zip(got, want):
            assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
        if kw.get("drop_last", True):
            ta, ja = t.epoch_indices(), j.epoch_indices()
            assert ta.dtype == ja.dtype and np.array_equal(ta, ja)
            assert np.array_equal(ta, np.stack([b["x"][:, 0] for b in got]))
        else:
            with pytest.raises(ValueError):
                t.epoch_indices()
