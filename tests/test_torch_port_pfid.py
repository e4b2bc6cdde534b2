"""The port's P-FID/P-IS layer and FPS tools against the JAX package's, on the CPU.

The numpy copies (``fid_is``, ``npz_stream``) give equal numbers; the grouping gives equal
indices; the PointNet++ modules (SSG, MSG, FP) agree in fp32 and fp64 on the same seeded
weights, which reach JAX through its own importer of the reference's layout; the weight
carry-across equals the JAX exporter; the extractor and the two CLIs agree with the JAX
ones; the native FPS the port builds is index-exact with both FPS implementations; the
downsampling tool writes the JAX tool's arrays; ``TriMesh`` writes the same bytes; plotting
runs headless. Distances keep fp64 (``square_distance``), and fp32 distances are
unchanged bit for bit.

Tolerances are max |error| over max |reference|: fp32 1e-5 (the same products summed in
another order through the convolution stacks), fp64 1e-10.
"""

import functools
import importlib
import io
import warnings

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcdiff.cli import downsample as jdown
from pcdiff.cli import evaluate_pfid as jpfid
from pcdiff.cli import evaluate_pis as jpis
from pcdiff.evals import feature_extractor as jfe
from pcdiff.evals import fid_is as jfid
from pcdiff.evals import npz_stream as jnpz
from pcdiff.evals import pointnet2 as jpn
from pcdiff.geometry import mesh as jmesh
from pcdiff_torch.cli import downsample as tdown
from pcdiff_torch.cli import evaluate_pfid as tpfid
from pcdiff_torch.cli import evaluate_pis as tpis
from pcdiff_torch.evals import feature_extractor as tfe
from pcdiff_torch.evals import fid_is as tfid
from pcdiff_torch.evals import npz_stream as tnpz
from pcdiff_torch.evals import pointnet2 as tpn
from pcdiff_torch.geometry import fps_native as tnative
from pcdiff_torch.geometry import mesh as tmesh
from pcdiff_torch.geometry import ops as tops

# the packages' geometry namespaces export a function named fps, which hides the module
jfps = importlib.import_module("pcdiff.geometry.fps")
tfps = importlib.import_module("pcdiff_torch.geometry.fps")

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores
TOL = {np.float32: 1e-5, np.float64: 1e-10}
DTYPES = [np.float32, np.float64]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _clouds(seed, b, n, d=3):
    pc = np.random.default_rng(seed).standard_normal((b, n, d))
    pc[..., :3] = tfe.normalize_point_clouds(pc[..., :3])
    return pc.astype(np.float32)


def _state(module: torch.nn.Module, seed: int) -> dict:
    """A seeded numpy ``state_dict`` of ``module``'s names and shapes, in the reference's
    layout: weights and biases U(+-1/sqrt(fan_in)), batch-norm scales U(0.8, 1.2) and
    shifts U(-0.1, 0.1), running means U(-0.2, 0.2) and variances U(0.8, 1.2), as the JAX
    package's CLI test randomises them."""
    rng = np.random.default_rng(seed)
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    sd = {}
    for k, shape in shapes.items():
        layer, leaf = k.rsplit(".", 1)
        if leaf == "num_batches_tracked":
            sd[k] = np.zeros((), np.int64)
            continue
        if f"{layer}.running_mean" in shapes:  # a batch norm
            lo, hi = dict(weight=(0.8, 1.2), bias=(-0.1, 0.1), running_mean=(-0.2, 0.2),
                          running_var=(0.8, 1.2))[leaf]
        else:
            bound = 1.0 / np.sqrt(np.prod(shapes[f"{layer}.weight"][1:]))
            lo, hi = -bound, bound
        sd[k] = rng.uniform(lo, hi, shape).astype(np.float32)
    return sd


def _load(module, sd, dtype=np.float32):
    module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                           strict=True)
    return module.to({np.float32: torch.float32, np.float64: torch.float64}[dtype]).eval()


def _jax(fn, variables, args, dtype):
    """``fn(variables, *args)`` in JAX on numpy inputs; fp64 under ``enable_x64``, so x64
    does not leak into the worker's other tests."""
    def run():
        cast = lambda a: jnp.asarray(np.asarray(a, dtype))  # noqa: E731
        out = fn(jax.tree_util.tree_map(cast, variables),
                 *[None if a is None else cast(a) for a in args])
        return jax.tree_util.tree_map(np.asarray, out)
    if dtype == np.float64:
        with jax.enable_x64(True):
            return run()
    return run()


def _torch(module, args, dtype, **kw):
    with torch.no_grad():
        out = module(*[None if a is None else torch.from_numpy(np.asarray(a, dtype))
                       for a in args], **kw)
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


_JIT = {}


def _jit(name, fn):
    """One jitted JAX program per model for the file (retraced per dtype only)."""
    if name not in _JIT:
        _JIT[name] = jax.jit(fn)
    return _JIT[name]


# -------------------------------------------------------------- numpy copies

@pytest.mark.parametrize("case", ["regular", "singular", "pis", "pis_zeros_splits"])
def test_fid_is_equal_jax(case):
    rng = np.random.default_rng(1)
    if case.startswith("pis"):
        preds = rng.dirichlet(np.ones(10) * 0.3, size=40)
        split = 5000
        if case == "pis_zeros_splits":
            preds[::3, 2] = 0.0  # class probabilities that underflowed to 0
            split = 7
        got = tfid.compute_inception_score(preds, split)
        assert got == jfid.compute_inception_score(preds, split) and np.isfinite(got)
        return
    n, d = (6, 16) if case == "singular" else (60, 8)  # singular: fewer samples than dims
    a, b = rng.standard_normal((n, d)), rng.standard_normal((n, d)) * 1.1 + 0.3
    got, want = [], []
    for mod, out in ((tfid, got), (jfid, want)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out.append(mod.compute_statistics(a).frechet_distance(
                mod.compute_statistics(b)))
        # the JAX copy also warns that SciPy deprecates sqrtm's disp argument
        out.append([str(w.message) for w in caught
                    if not issubclass(w.category, DeprecationWarning)])
    assert got == want and np.isfinite(got[0])


def _shards(tmp_path):
    rng = np.random.default_rng(2)
    arrs = [dict(arr_0=rng.standard_normal((n, 5, 3)).astype(np.float32),
                 labels=np.arange(n, dtype=np.int64)) for n in (7, 4, 9)]
    for i, a in enumerate(arrs):
        np.savez(tmp_path / f"s_{i:03d}.npz", **a)
    np.savez(tmp_path / "fortran.npz", arr_0=np.asfortranarray(arrs[0]["arr_0"]),
             labels=arrs[0]["labels"])
    return str(tmp_path / "s_*.npz")


@pytest.mark.parametrize("path, batch, keys", [
    ("s_*.npz", 5, None), ("s_*.npz", 20, ["arr_0"]), ("s_*.npz[:10]", 3, None),
    ("s_*.npz[:16]", 4, ["labels", "arr_0"]), ("fortran.npz", 3, None),
])
def test_npz_stream_equal_jax(tmp_path, path, batch, keys):
    _shards(tmp_path)
    glob = str(tmp_path / path)
    got = list(tnpz.NpzStreamer(glob).stream(batch, keys))
    want = list(jnpz.NpzStreamer(glob).stream(batch, keys))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in g:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k])
    infos = [{k: (v.name, v.dtype, v.shape, v.elem_shape) for k, v in
              mod.NumpyArrayInfo.infos_from_first_file(glob).items()} for mod in (tnpz, jnpz)]
    assert infos[0] == infos[1] and set(infos[0]) == {"arr_0", "labels"}


# ------------------------------------------------------------------ grouping

def _jax_grouping(v, xyz, new_xyz, pts):
    """The JAX package's ball query, grouping (with and without features) and group-all
    in one program."""
    return (jpn.query_ball_point(0.3, 16, xyz, new_xyz),
            jpn.sample_and_group(24, 0.4, 12, xyz, pts),
            jpn.sample_and_group(24, 0.4, 12, xyz, None),
            jpn.sample_and_group_all(xyz, pts), jpn.sample_and_group_all(xyz, None))


@pytest.mark.parametrize("dtype", DTYPES)
def test_grouping_equal_jax(dtype):
    xyz, pts = _clouds(3, 2, 200), _clouds(4, 2, 200, 5)[..., 3:]
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a, dtype))  # noqa: E731
    want = _jax(_jit("grouping", _jax_grouping), {}, (xyz, xyz[:, ::7], pts), dtype)
    assert np.array_equal(tpn.query_ball_point(0.3, 16, t(xyz), t(xyz[:, ::7])).numpy(),
                          want[0])
    got = (tpn.sample_and_group(24, 0.4, 12, t(xyz), t(pts)),
           tpn.sample_and_group(24, 0.4, 12, t(xyz), None))
    for g_pair, w_pair in zip(got, want[1:3]):
        for g, w in zip(g_pair, w_pair):
            assert g.dtype == {np.float32: torch.float32, np.float64: torch.float64}[dtype]
            if dtype == np.float64:
                assert np.array_equal(g.numpy(), w)
            else:
                assert _rel(g.numpy(), w) <= 1e-6
    for points, w_pair in ((pts, want[3]), (None, want[4])):
        g_pair = tpn.sample_and_group_all(t(xyz), t(points))
        assert all(np.array_equal(g.numpy(), w) for g, w in zip(g_pair, w_pair))


def test_square_distance_keeps_fp64_and_fp32_bits():
    a, b = _clouds(5, 2, 40), _clouds(6, 2, 30)
    got = tops.square_distance(torch.from_numpy(a), torch.from_numpy(b))
    src, dst = torch.from_numpy(a).float(), torch.from_numpy(b).float()  # the old formula
    old = torch.clamp_min((src * src).sum(-1, keepdim=True)
                          + (dst * dst).sum(-1, keepdim=True).transpose(-1, -2)
                          - 2.0 * torch.matmul(src, dst.transpose(-1, -2)), 0.0)
    assert got.dtype == torch.float32 and torch.equal(got, old)
    half = tops.square_distance(torch.from_numpy(a).bfloat16(), torch.from_numpy(b))
    assert half.dtype == torch.float32
    d64 = tops.square_distance(torch.from_numpy(a).double(), torch.from_numpy(b).double())
    assert d64.dtype == torch.float64
    exact = ((a.astype(np.float64)[:, :, None] - b.astype(np.float64)[:, None]) ** 2).sum(-1)
    assert np.abs(d64.numpy() - exact).max() <= 1e-15
    assert np.abs(got.numpy() - exact).max() > 1e-9  # fp32 would not do


# -------------------------------------------------------------------- models

@pytest.mark.parametrize("width, dtype", [(1, np.float32), (1, np.float64), (2, np.float32)])
def test_ssg_equals_jax(width, dtype):
    xyz = _clouds(7, 2, 1024)
    model = tpn.PointNet2ClassifierSSG(width_mult=width)
    sd = _state(model, 10 + width)
    got = _torch(_load(model, sd, dtype), (xyz,), dtype, features=True)
    jmodel = jpn.PointNet2ClassifierSSG(num_class=40, width_mult=width)
    want = _jax(_jit(f"ssg{width}", lambda v, x: jmodel.apply(v, x, features=True)),
                jpn.import_pointnet2_torch_state(sd), (xyz,), dtype)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL[dtype]


_MSG = dict(npoint=24, radius_list=(0.2, 0.4), nsample_list=(8, 16),
            mlp_list=((8, 16), (8, 8, 12)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_msg_equals_jax(dtype):
    data = _clouds(8, 2, 160, 7)
    xyz, pts = data[..., :3], data[..., 3:]
    model = tpn.PointNetSetAbstractionMsg(in_channel=4, **_MSG)
    sd = _state(model, 20)
    got = _torch(_load(model, sd, dtype), (xyz, pts), dtype)
    jmodel = jpn.PointNetSetAbstractionMsg(**_MSG)
    want = _jax(_jit("msg", jmodel.apply), jpn.import_sa_msg_torch_state(sd, 2), (xyz, pts),
                dtype)
    assert got[1].shape == (2, 24, 28)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL[dtype]


@pytest.mark.parametrize("dtype, sources", [(np.float32, 24), (np.float64, 24),
                                            (np.float64, 1)])
def test_fp_equals_jax(dtype, sources):
    """FP in fp64 from 24 sources is held to fp32's limit: the JAX package takes the
    three-nearest weights from fp32 distances even under x64 (its ``square_distance``
    computes in fp32), the port from fp64 ones (measured 5.6e-7). With one source the
    weights drop out and fp64's limit holds."""
    data = _clouds(9, 2, 96, 7)
    xyz1, pts1 = data[..., :3], data[..., 3:]
    xyz2 = np.random.default_rng(10).uniform(-0.5, 0.5, (2, sources, 3)).astype(np.float32)
    pts2 = np.random.default_rng(11).standard_normal((2, sources, 6)).astype(np.float32)
    model = tpn.PointNetFeaturePropagation(in_channel=10, mlp=(16, 8))
    sd = _state(model, 30)
    got = _torch(_load(model, sd, dtype), (xyz1, xyz2, pts1, pts2), dtype)[0]
    jmodel = jpn.PointNetFeaturePropagation(mlp=(16, 8))
    want = _jax(_jit("fp", jmodel.apply), jpn.import_fp_torch_state(sd),
                (xyz1, xyz2, pts1, pts2), dtype)
    assert _rel(got, want) <= TOL[np.float32 if sources > 1 else dtype]


# ------------------------------------------------------------------- weights

def test_state_from_flax_equals_jax_export():
    model = tpn.PointNet2ClassifierSSG(width_mult=1)
    variables = jpn.import_pointnet2_torch_state(_state(model, 40))
    got = tpn.pointnet2_state_from_flax(variables)
    want = jpn.export_pointnet2_torch_state(variables)
    assert set(got) - set(want) == {k for k in got if k.endswith("num_batches_tracked")}
    for k, w in want.items():
        assert got[k].numpy().dtype == w.dtype and np.array_equal(got[k].numpy(), w), k
    model.load_state_dict(got, strict=True)
    back = jpn.import_pointnet2_torch_state(model.state_dict())
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b), back, variables)

    msg = tpn.PointNetSetAbstractionMsg(in_channel=4, **_MSG)
    v_msg = jpn.import_sa_msg_torch_state(_state(msg, 41), 2)
    msg.load_state_dict(tpn.sa_msg_state_from_flax(v_msg, 2), strict=True)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b),
                           jpn.import_sa_msg_torch_state(msg.state_dict(), 2), v_msg)
    fp = tpn.PointNetFeaturePropagation(in_channel=10, mlp=(16, 8))
    v_fp = jpn.import_fp_torch_state(_state(fp, 42))
    fp.load_state_dict(tpn.fp_state_from_flax(v_fp), strict=True)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, b),
                           jpn.import_fp_torch_state(fp.state_dict()), v_fp)


def test_pointwise_runs_no_convolution(monkeypatch):
    """Each 1x1 convolution is a matmul: F.conv1d/conv2d (cuDNN on the card) never run."""
    def refuse(*a, **k):
        raise AssertionError("a convolution ran")
    monkeypatch.setattr(torch.nn.functional, "conv1d", refuse)
    monkeypatch.setattr(torch.nn.functional, "conv2d", refuse)
    model = tpn.PointNet2ClassifierSSG(width_mult=1)
    _load(model, _state(model, 43))
    with torch.no_grad():
        lp, l3, feats = model(torch.from_numpy(_clouds(12, 2, 64)), features=True)
    assert lp.shape == (2, 40) and l3.shape == (2, 1, 1024) and feats.shape == (2, 256)
    conv = model.sa1.mlp_convs[0]
    x = torch.randn(2, 5, 7, 3, dtype=torch.float64)
    monkeypatch.undo()
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), conv.weight.double(),
                                      conv.bias.double()).permute(0, 2, 3, 1)
    assert torch.allclose(conv.double()(x), want, rtol=1e-12, atol=1e-12)


# ----------------------------------------------------------------- extractor

def test_extractor_equals_jax():
    model = tpn.PointNet2ClassifierSSG(width_mult=1)
    sd = _state(model, 50)
    clouds = np.random.default_rng(13).standard_normal((5, 128, 3)) * 2.0 + 0.5
    got = tfe.PointNetClassifier(state_dict=sd, batch_size=2, width_mult=1,
                                 device="cpu").features_and_preds(clouds)
    want = jfe.PointNetClassifier(params=jpn.import_pointnet2_torch_state(sd), batch_size=2,
                                  width_mult=1).features_and_preds(clouds)
    assert got[0].shape == (5, 256) and got[1].shape == (5, 40)
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL[np.float32]
    assert np.allclose(got[1].sum(-1), 1.0, atol=1e-5)


def test_extractor_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tfe.PointNetClassifier(state_dict={})


# The CLIs build the extractor at its defaults, width 2 in chunks of 64, which would take
# ~50 s here for the two CLIs of both packages; both packages' CLIs take the same narrower
# extractor (width 1, chunks of 8: two a batch, the first re-batched across the shards).
# test_ssg_equals_jax holds width 2.
CLI_EXTRACTOR = dict(width_mult=1, batch_size=8)


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """Two npz batches (the first in two shards) and a reference-layout checkpoint, as the
    JAX package's CLI test builds them."""
    tmp = tmp_path_factory.mktemp("pfid")
    model = tpn.PointNet2ClassifierSSG(width_mult=CLI_EXTRACTOR["width_mult"])
    ckpt = str(tmp / "pointnet.pt")
    torch.save({"model_state_dict": {k: torch.from_numpy(np.array(v))
                                     for k, v in _state(model, 60).items()}}, ckpt)
    rng = np.random.default_rng(0)
    n, p = 16, 64
    batch1 = rng.standard_normal((n, p, 3)).astype(np.float32)
    batch2 = (rng.standard_normal((n, p, 3)) * 1.2 + 0.1).astype(np.float32)
    np.savez(tmp / "a_000.npz", arr_0=batch1[:6])
    np.savez(tmp / "a_001.npz", arr_0=batch1[6:])
    np.savez(tmp / "b_000.npz", arr_0=batch2)
    return tmp, ckpt


def _last(out: str, key: str) -> float:
    return float(out.strip().splitlines()[-1].split(key)[1])


@pytest.mark.parametrize("cli", ["pfid", "pis"])
def test_clis_print_the_jax_numbers(cli_data, cli, monkeypatch, capsys):
    tmp, ckpt = cli_data
    if cli == "pfid":
        args = [str(tmp / "a_*.npz"), str(tmp / "b_000.npz"), "--checkpoint", ckpt]
        port, jax_cli, key = tpfid, jpfid, "P-FID:"
    else:
        args = [str(tmp / "a_*.npz"), "--checkpoint", ckpt]
        port, jax_cli, key = tpis, jpis, "P-IS:"
    monkeypatch.setattr(port, "PointNetClassifier",
                        functools.partial(tfe.PointNetClassifier, **CLI_EXTRACTOR))
    monkeypatch.setattr(jax_cli, "PointNetClassifier",
                        functools.partial(jfe.PointNetClassifier, **CLI_EXTRACTOR))
    got = port.main(args + ["--device", "cpu"])
    assert _last(capsys.readouterr().out, key) == got
    monkeypatch.setattr("sys.argv", [f"evaluate_{cli}"] + args)
    jax_cli.main()
    want = _last(capsys.readouterr().out, key)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=2e-3)


# ------------------------------------------------------- native FPS, downsample

def test_native_fps_index_exact():
    pts = np.random.default_rng(14).standard_normal((3, 300, 3)).astype(np.float32)
    pts[1, 50:60] = pts[1, 40]  # exact ties: the first argmax wins everywhere
    got = tnative.native_fps_indices(pts, 64)
    assert got is not None and got.dtype == np.int32
    assert np.array_equal(got, tfps.farthest_point_sample(torch.from_numpy(pts), 64,
                                                          deterministic=True).numpy())
    assert np.array_equal(got, np.asarray(jfps.farthest_point_sample(
        jnp.asarray(pts), 64, deterministic=True)))
    starts = np.array([5, 0, 299], np.int32)
    with_starts = tnative.native_fps_indices(pts, 16, starts=starts)
    assert np.array_equal(with_starts[:, 0], starts)
    for bad in (dict(starts=np.array([1, 2])), dict(starts=np.array([-1, 0, 0]))):
        with pytest.raises(ValueError):
            tnative.native_fps_indices(pts, 16, **bad)


def _h5(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda n, o: out.__setitem__(n, o[()]) if isinstance(o, h5py.Dataset)
                     else None)
    return out


def test_downsample_writes_the_jax_arrays(tmp_path, monkeypatch):
    rng = np.random.default_rng(15)
    src = tmp_path / "full.h5"
    with h5py.File(src, "w") as f:
        for cls, sizes in (("chair", (300, 120)), ("guitar", (300,)), ("lamp", (90, 300))):
            for i, n in enumerate(sizes):
                g = f.create_group(f"{cls}/{cls}_{i:04d}")
                g["ground_truth"] = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
                for s, m in enumerate((200, 40)):
                    sg = g.create_group(f"partials/scan_{s:04d}")
                    sg["pointcloud"] = rng.uniform(-0.5, 0.5, (m, 3)).astype(np.float32)
                    sg["distance"] = rng.random((8, 8)).astype(np.float32)
    args = ["--n", "64", "--min-points", "100"]
    tdown.main([str(src), str(tmp_path / "port.h5"), *args], device="cpu")
    monkeypatch.setattr("sys.argv", ["downsample", str(src), str(tmp_path / "jax.h5"), *args])
    jdown.main()
    got, want = _h5(tmp_path / "port.h5"), _h5(tmp_path / "jax.h5")
    assert sorted(got) == sorted(want) and len(got) == 9
    assert all(np.array_equal(got[k], want[k]) for k in got)
    # without the native library the tool takes the port's FPS on the device named
    clouds = [rng.standard_normal((150, 3)).astype(np.float32) for _ in range(2)]
    native = tdown.fps_batch(clouds, 32, device="cpu")
    monkeypatch.setattr(tdown, "native_fps_indices", lambda *a, **k: None)
    assert np.array_equal(tdown.fps_batch(clouds, 32, device="cpu"), native)


# ------------------------------------------------------------- mesh, plotting

def test_trimesh_equals_jax(tmp_path):
    rng = np.random.default_rng(16)
    kw = dict(verts=rng.standard_normal((10, 3)).astype(np.float32),
              faces=rng.integers(0, 10, (6, 3)).astype(np.int32),
              normals=rng.standard_normal((6, 3)).astype(np.float32),
              vertex_channels={c: rng.random(10).astype(np.float32) for c in "RGB"},
              face_channels={"area": rng.random(6).astype(np.float32)})
    for drop_colors in (False, True):
        if drop_colors:
            kw["vertex_channels"] = {}
        plys = []
        for mod in (tmesh, jmesh):
            buf = io.BytesIO()
            mod.TriMesh(**kw).write_ply(buf)
            plys.append(buf.getvalue())
        assert plys[0] == plys[1]
    path = str(tmp_path / "m.npz")
    tmesh.TriMesh(**kw).save(path)
    a, b = tmesh.TriMesh.load(path), jmesh.TriMesh.load(path)
    assert np.array_equal(a.verts, b.verts) and np.array_equal(a.normals, b.normals)
    assert list(a.face_channels) == list(b.face_channels) == ["area"]


def test_plotting_runs_headless():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from pcdiff_torch.geometry.point_cloud import PointCloud
    from pcdiff_torch.utils.plotting import plot_point_cloud

    rng = np.random.default_rng(17)
    pc = PointCloud(coords=rng.uniform(-0.5, 0.5, (50, 3)).astype(np.float32),
                    channels={c: rng.random(50).astype(np.float32) for c in "RGB"})
    for grid, bounds in ((2, ((-0.75,) * 3, (0.75,) * 3)), (1, None)):
        fig = plot_point_cloud(pc, grid_size=grid, fixed_bounds=bounds)
        assert len(fig.axes) == grid * grid
        fig.canvas.draw()
        plt.close(fig)
