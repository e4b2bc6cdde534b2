"""The port's evaluation layer against the JAX package's: the geometry ops that the
metrics use, deterministic FPS (indices exact), PLY bytes, the ``PointCloud`` container,
the batch savers and ``CompletionMetrics`` (with its FPS-to-1024 branch)."""

import importlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdiff.evals import metrics as jmetrics
from pcdiff.geometry import ops as jops
from pcdiff.geometry import ply as jply
from pcdiff.geometry import point_cloud as jpc
from pcdiff.utils import io as jio
from pcdiff_torch.evals import metrics as tmetrics
from pcdiff_torch.geometry import ops as tops
from pcdiff_torch.geometry import ply as tply
from pcdiff_torch.geometry import point_cloud as tpc
from pcdiff_torch.utils import io as tio

# the packages' geometry namespaces export a function named fps, which hides the module
jfps = importlib.import_module("pcdiff.geometry.fps")
tfps = importlib.import_module("pcdiff_torch.geometry.fps")

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores
RTOL = 1e-6


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


@pytest.fixture(scope="module")
def clouds():
    rng = np.random.default_rng(0)
    return (rng.uniform(-0.5, 0.5, (3, 200, 6)).astype(np.float32),
            rng.uniform(-0.5, 0.5, (3, 150, 6)).astype(np.float32))


@pytest.mark.parametrize("name", ["square_distance", "chamfer_distance", "chamfer_distance_xyz",
                                  "chamfer_distance_color"])
def test_distances_equal_jax(clouds, name):
    a, b = clouds
    _close(getattr(tops, name)(torch.from_numpy(a), torch.from_numpy(b)),
           getattr(jops, name)(jnp.asarray(a), jnp.asarray(b)))


def test_color_chamfer_needs_six_channels(clouds):
    a, b = clouds
    with pytest.raises(ValueError):
        tops.chamfer_distance_color(torch.from_numpy(a[..., :3]), torch.from_numpy(b[..., :3]))


@pytest.mark.parametrize("name,threshold", [("fscore", 0.03), ("fscore", 0.08),
                                            ("fscore_squared", 1e-4), ("fscore_squared", 4e-3)])
def test_fscores_equal_jax(clouds, name, threshold):
    a, b = (c[..., :3] for c in clouds)
    got = getattr(tops, name)(torch.from_numpy(a), torch.from_numpy(b), threshold=threshold)
    want = getattr(jops, name)(jnp.asarray(a), jnp.asarray(b), threshold=threshold)
    for g, w in zip(got, want):
        _close(g, w)
    assert float(want[0].max()) > 0.0


def test_index_points_and_knn_equal_jax(clouds):
    a, b = clouds
    idx = np.random.default_rng(1).integers(0, 200, (3, 7, 4)).astype(np.int32)
    got = tops.index_points(torch.from_numpy(a), torch.from_numpy(idx))
    assert np.array_equal(got.numpy(), np.asarray(jops.index_points(jnp.asarray(a),
                                                                     jnp.asarray(idx))))
    d, i = tops.knn(torch.from_numpy(b), torch.from_numpy(a), 5)
    jd, ji = jops.knn(jnp.asarray(b), jnp.asarray(a), 5)
    assert np.array_equal(i.numpy(), np.asarray(ji))
    _close(d, jd)


@pytest.mark.parametrize("n,m,dtype", [(300, 64, np.float32), (1100, 1024, np.float32),
                                       (130, 40, "bfloat16")])
def test_fps_deterministic_equals_jax(n, m, dtype):
    pts = np.random.default_rng(n).uniform(-0.5, 0.5, (4, n, 3)).astype(np.float32)
    if dtype == "bfloat16":
        t_in = torch.from_numpy(pts).bfloat16()
        j_in = jnp.asarray(pts).astype(jnp.bfloat16)
    else:
        t_in, j_in = torch.from_numpy(pts), jnp.asarray(pts)
    got = tfps.farthest_point_sample(t_in, m, deterministic=True)
    want = np.asarray(jfps.farthest_point_sample(j_in, m, deterministic=True))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got[:, 0].numpy(), np.arange(4) % n)  # element b starts at b
    sub = tfps.fps(t_in, m, deterministic=True)
    assert np.array_equal(sub.float().numpy(), np.asarray(
        jfps.fps(j_in, m, deterministic=True)).astype(np.float32))


def test_fps_random_start_from_the_generator():
    pts = torch.rand(2, 50, 3, generator=torch.Generator().manual_seed(0))
    a = tfps.farthest_point_sample(pts, 10, generator=torch.Generator().manual_seed(5))
    b = tfps.farthest_point_sample(pts, 10, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and all(len(set(r.tolist())) == 10 for r in a)


PLY_CASES = ["coords", "rgb", "faces", "rgb+faces"]


@pytest.mark.parametrize("case", PLY_CASES)
def test_write_ply_bytes_equal_jax(case):
    rng = np.random.default_rng(3)
    kw = dict(coords=rng.standard_normal((37, 3)).astype(np.float32))
    if "rgb" in case:
        kw["rgb"] = rng.random((37, 3))
    if "faces" in case:
        kw["faces"] = rng.integers(0, 37, (11, 3))
    got, want = io.BytesIO(), io.BytesIO()
    tply.write_ply(got, **kw)
    jply.write_ply(want, **kw)
    assert got.getvalue() == want.getvalue()
    back, jback = tply.read_ply(io.BytesIO(got.getvalue())), jply.read_ply(io.BytesIO(
        want.getvalue()))
    assert back.keys() == jback.keys()
    assert all(np.array_equal(back[k], jback[k]) for k in back)
    assert np.array_equal(back["coords"], kw["coords"])


def _pcs():
    rng = np.random.default_rng(4)
    coords = rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    channels = {c: rng.random(60).astype(np.float32) for c in "RGB"}
    return (tpc.PointCloud(coords=coords, channels=dict(channels)),
            jpc.PointCloud(coords=coords, channels=dict(channels)))


def _same_pc(a, b):
    assert np.array_equal(a.coords, b.coords)
    assert a.channels.keys() == b.channels.keys()
    assert all(np.array_equal(a.channels[k], b.channels[k]) for k in a.channels)


def test_point_cloud_methods_equal_jax(tmp_path):
    t, j = _pcs()
    _same_pc(t.random_sample(20, rng=np.random.default_rng(1)),
             j.random_sample(20, rng=np.random.default_rng(1)))
    _same_pc(t.farthest_point_sample(25, rng=np.random.default_rng(2)),
             j.farthest_point_sample(25, rng=np.random.default_rng(2)))
    _same_pc(t.farthest_point_sample(25, init_idx=3), j.farthest_point_sample(25, init_idx=3))
    idx = np.arange(0, 60, 3)
    _same_pc(t.subsample(idx, average_neighbors=True), j.subsample(idx, average_neighbors=True))
    assert np.array_equal(t.select_channels(["R", "B"]), j.select_channels(["R", "B"]))
    q = np.random.default_rng(5).uniform(-1, 1, (30, 3)).astype(np.float32)
    assert np.array_equal(t.nearest_points(q, batch_size=7), j.nearest_points(q, batch_size=7))
    _same_pc(t.combine(t), j.combine(j))
    assert len(t) == len(j) == 60
    t.save(str(tmp_path / "t.npz"))
    _same_pc(tpc.PointCloud.load(str(tmp_path / "t.npz")), j)
    got, want = io.BytesIO(), io.BytesIO()
    t.write_ply(got)
    j.write_ply(want)
    assert got.getvalue() == want.getvalue()


@pytest.mark.parametrize("fmt", ["ply", "npz"])
def test_batch_savers_write_the_same_files(tmp_path, fmt):
    batch = np.random.default_rng(6).uniform(-0.5, 0.5, (3, 20, 3)).astype(np.float32)
    colors = np.random.default_rng(7).random((3, 20, 3)).astype(np.float32)
    tio.save_target_point_clouds(batch, str(tmp_path / "t"), prefix="p", colors=colors, fmt=fmt)
    jio.save_target_point_clouds(batch, str(tmp_path / "j"), prefix="p", colors=colors, fmt=fmt)
    tio.save_samples(batch, str(tmp_path / "ts"), fmt=fmt)
    jio.save_samples(batch, str(tmp_path / "js"), fmt=fmt)
    for a, b in (("t", "j"), ("ts", "js")):
        names = sorted(p.name for p in (tmp_path / a).iterdir())
        assert names == sorted(p.name for p in (tmp_path / b).iterdir()) and len(names) == 3
        for name in names:
            x, y = (tmp_path / a / name).read_bytes(), (tmp_path / b / name).read_bytes()
            if fmt == "ply":
                assert x == y
            else:
                _same_pc(tpc.PointCloud.load(io.BytesIO(x)), jpc.PointCloud.load(io.BytesIO(y)))


def test_batch_cd_f1_equals_jax(clouds):
    a, b = (c[..., :3] for c in clouds)
    got = tmetrics.batch_cd_f1(torch.from_numpy(a), torch.from_numpy(b))
    want = jmetrics.batch_cd_f1(jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        _close(g, w)


def _summary_close(got, want):
    assert got.keys() == want.keys() and got["per_class"].keys() == want["per_class"].keys()
    for g, w in [(got["overall"], want["overall"])] + [
            (got["per_class"][k], want["per_class"][k]) for k in want["per_class"]]:
        assert g["count"] == w["count"]
        for key in ("cd_full", "f1_full", "f1_squared_full", "cd_fps", "f1_fps"):
            # within 1e-6: absolute below 1 (the CDs are ~1e-3, each a float32 mean summed
            # in another order), relative above
            assert abs(g[key] - w[key]) <= 1e-6 * max(abs(w[key]), 1.0), key


@pytest.mark.parametrize("n", [256, 1040], ids=["no_fps", "fps_to_1024"])
def test_completion_metrics_equal_jax(n):
    rng = np.random.default_rng(n)
    names = {0: "airplane", 1: "bench", 2: "car"}
    t = tmetrics.CompletionMetrics(fps_points=1024, device="cpu")
    j = jmetrics.CompletionMetrics(fps_points=1024)
    for rows in (4, 3):  # a ragged last batch
        gt = rng.uniform(-0.5, 0.5, (rows, n, 3)).astype(np.float32)
        pred = np.clip(gt + rng.normal(0, 0.02, gt.shape), -0.5, 0.5).astype(np.float32)
        labels = rng.integers(0, 3, rows).astype(np.int32)
        t.update(pred, gt, labels)
        j.update(pred, gt, labels)
    got, want = t.summary(class_names=names), j.summary(class_names=names)
    _summary_close(got, want)
    assert got["overall"]["count"] == 7 and want["overall"]["f1_full"] > 0
    if n > 1024:
        assert got["overall"]["cd_fps"] != got["overall"]["cd_full"]
    _summary_close(t.summary(), j.summary())


def test_completion_metrics_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmetrics.CompletionMetrics()
