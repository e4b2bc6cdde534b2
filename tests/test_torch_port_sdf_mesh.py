"""The port's perceiver, SDF model, isosurface extraction and point cloud -> mesh path
against the JAX package's, on the CPU in fp32.

The SDF model takes one reference ``state_dict`` synthesized from the key patterns of
``pcdiff/core/point_e_import.py``'s ``import_sdf_torch_state`` (every tensor nonzero; head
dim 64 in the encoder, 32 in the decoder, two heads or more): the JAX side through its
importer, the port through its own and through ``params_from_flax``. The standalone
perceiver reads data of another width than its queries. The JAX side runs the fused graph
(``set_ln_dense_fusion("on")``). Tolerance 1e-5 (a mesh vertex of the model's SDF 1e-4).
``marching_cubes`` and
``marching_tetrahedra`` are the port's own numpy copy and must give equal arrays; the mesh
path runs on an analytic sphere and on the tiny SDF model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pcdiff.core.point_e_import import import_sdf_torch_state as jimport
from pcdiff.geometry.point_cloud import PointCloud as JPointCloud
from pcdiff.models import attention as jattn
from pcdiff.models import configs as jconfigs
from pcdiff.models import perceiver as jperceiver
from pcdiff.utils import marching as jmarching
from pcdiff.utils import pc_to_mesh as jmesh
from pcdiff_torch.core import flax_from_params, params_from_flax
from pcdiff_torch.core.point_e_import import import_sdf_torch_state as timport
from pcdiff_torch.geometry.point_cloud import PointCloud as TPointCloud
from pcdiff_torch.models import configs as tconfigs
from pcdiff_torch.models import perceiver as tperceiver
from pcdiff_torch.utils import marching as tmarching
from pcdiff_torch.utils import pc_to_mesh as tmesh

torch.set_num_threads(1)  # one intra-op thread: the suite's xdist workers share the cores

SDF = dict(jconfigs.MODEL_CONFIGS["sdf"], width=128, encoder_layers=2, encoder_heads=2,
           decoder_layers=2, decoder_heads=4, n_ctx=24)


@pytest.fixture(autouse=True)
def _fused_graph():
    jattn.set_ln_dense_fusion("on")
    yield
    jattn.set_ln_dense_fusion("auto")


def _linear(sd, rng, prefix, out_f, in_f):
    sd[f"{prefix}.weight"] = (rng.standard_normal((out_f, in_f)) / np.sqrt(in_f)).astype(np.float32)
    sd[f"{prefix}.bias"] = (0.1 * rng.standard_normal(out_f)).astype(np.float32)


def _ln(sd, rng, prefix, c):
    sd[f"{prefix}.weight"] = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    sd[f"{prefix}.bias"] = (0.1 * rng.standard_normal(c)).astype(np.float32)


def sdf_state(cfg, seed=0):
    """A reference SDF ``state_dict`` (numpy) in the importers' key patterns."""
    rng = np.random.default_rng(seed)
    w, sd = cfg["width"], {}
    _linear(sd, rng, "encoder_input_proj", w, 3)
    _linear(sd, rng, "decoder_input_proj", w, 3)
    _ln(sd, rng, "ln_post", w)
    _linear(sd, rng, "output_proj", 1, w)
    for i in range(cfg["encoder_layers"]):
        p = f"encoder.resblocks.{i}"
        _ln(sd, rng, f"{p}.ln_1", w)
        _ln(sd, rng, f"{p}.ln_2", w)
        _linear(sd, rng, f"{p}.attn.c_qkv", 3 * w, w)
        _linear(sd, rng, f"{p}.attn.c_proj", w, w)
        _linear(sd, rng, f"{p}.mlp.c_fc", 4 * w, w)
        _linear(sd, rng, f"{p}.mlp.c_proj", w, 4 * w)
    for i in range(cfg["decoder_layers"]):
        p = f"decoder.resblocks.{i}"
        for ln in ("ln_1", "ln_2", "ln_3"):
            _ln(sd, rng, f"{p}.{ln}", w)
        _linear(sd, rng, f"{p}.attn.c_q", w, w)
        _linear(sd, rng, f"{p}.attn.c_kv", 2 * w, w)
        _linear(sd, rng, f"{p}.attn.c_proj", w, w)
        _linear(sd, rng, f"{p}.mlp.c_fc", 4 * w, w)
        _linear(sd, rng, f"{p}.mlp.c_proj", w, 4 * w)
    return sd


@pytest.fixture(scope="module")
def sdf():
    sd = sdf_state(SDF)
    variables, state = jimport(sd), timport(sd)
    model = tconfigs.model_from_config(SDF, device="cpu")
    model.load_state_dict(state, strict=True)
    return jconfigs.model_from_config(SDF), variables, model.eval(), state


def _close(got, want, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def test_sdf_importers_agree_and_carry_across(sdf):
    _, variables, model, state = sdf
    via_flax = params_from_flax(variables)
    assert via_flax.keys() == state.keys()
    for k in state:
        assert torch.equal(via_flax[k], state[k]), k
    back = traverse_util.flatten_dict(flax_from_params(model))
    want = traverse_util.flatten_dict(variables["params"])
    assert back.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


def test_sdf_matches_jax(sdf):
    jmod, variables, model, _ = sdf
    rng = np.random.default_rng(1)
    clouds = rng.uniform(-0.5, 0.5, (2, SDF["n_ctx"], 3)).astype(np.float32)
    queries = rng.uniform(-0.6, 0.6, (2, 37, 3)).astype(np.float32)

    @jax.jit
    def run(v, c, q):
        enc = jmod.apply(v, c, method=type(jmod).encode_point_clouds)
        return enc["latents"], jmod.apply(v, q, point_clouds=c)

    latents, want = run(variables, clouds, queries)
    with torch.no_grad():
        enc = model.encode_point_clouds(torch.from_numpy(clouds))
        _close(enc["latents"], latents)
        got = model.predict_sdf(torch.from_numpy(queries), enc)
        assert got.shape == (2, 37) and got.dtype == torch.float32
        _close(got, want)
        _close(model(torch.from_numpy(queries), point_clouds=torch.from_numpy(clouds)), want)
    with pytest.raises(ValueError):
        model(torch.from_numpy(queries))


def test_perceiver_reads_data_of_another_width():
    width, data_width, heads = 64, 48, 2
    jmod = jperceiver.SimplePerceiver(width, 2, heads, data_width=data_width)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, width)).astype(np.float32)
    data = rng.standard_normal((2, 9, data_width)).astype(np.float32)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), x, data)["params"]
    flat = {}
    for path, s in traverse_util.flatten_dict(shapes).items():
        z = rng.standard_normal(s.shape).astype(np.float32)
        flat[path] = {"kernel": z / np.sqrt(s.shape[0]), "scale": 1 + 0.1 * z}.get(path[-1],
                                                                                    0.1 * z)
    params = traverse_util.unflatten_dict(flat)
    want = jax.jit(jmod.apply)({"params": params}, x, data)
    model = tperceiver.SimplePerceiver(width, 2, heads, data_width=data_width, device="cpu")
    model.load_state_dict(params_from_flax(params), strict=True)
    with torch.no_grad():
        _close(model(torch.from_numpy(x), torch.from_numpy(data)), want)


def _volumes():
    rng = np.random.default_rng(3)
    g = np.linspace(-1, 1, 11, dtype=np.float32)
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    sphere = 0.7 - np.sqrt(xx ** 2 + yy ** 2 + zz ** 2)
    return {"sphere": sphere, "noise": rng.standard_normal((7, 8, 9)).astype(np.float32),
            "torus": (0.3 - np.sqrt((np.sqrt(xx ** 2 + yy ** 2) - 0.6) ** 2 + zz ** 2))}


@pytest.mark.parametrize("name", ["sphere", "noise", "torus"])
def test_marching_equals_jax(name):
    vol = _volumes()[name]
    for kw in ({}, {"level": 0.1, "spacing": (0.5, 0.25, 2.0)},
               {"gradient_direction": "ascent"}):
        got, want = tmarching.marching_cubes(vol, **kw), jmarching.marching_cubes(vol, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for level in (0.0, 0.2):
        got = tmarching.marching_tetrahedra(vol, level=level)
        want = jmarching.marching_tetrahedra(vol, level=level)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def _cloud(pc_cls, n=200, seed=4):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((n, 3))
    p = (0.35 * p / np.linalg.norm(p, axis=1, keepdims=True)).astype(np.float32)
    chans = {c: rng.uniform(0, 1, n).astype(np.float32) for c in "RGB"}
    return pc_cls(coords=p, channels=chans)


class _SphereSDF(torch.nn.Module):
    """An analytic SDF with the SDF model's interface: 0.35 - |q|."""

    def encode_point_clouds(self, clouds):
        return clouds

    def predict_sdf(self, queries, encoded):
        return 0.35 - torch.linalg.norm(queries, dim=-1)


@pytest.mark.parametrize("method", ["cubes", "tetrahedra"])
def test_pc_to_mesh_on_an_analytic_sphere(method):
    """An analytic SDF, 0.35 - |q| (the JAX side's as callables), over a 16^3 lattice in
    padded chunks."""
    kw = dict(batch_size=1000, grid_size=16, method=method)
    got = tmesh.marching_cubes_mesh(_cloud(TPointCloud), _SphereSDF(), **kw)
    want = jmesh.marching_cubes_mesh(
        _cloud(JPointCloud), encode_fn=lambda c: c,
        predict_fn=lambda q, enc: 0.35 - jnp.linalg.norm(q, axis=-1), **kw)
    assert len(got.faces) > 100
    np.testing.assert_array_equal(got.faces, want.faces)
    _close(got.verts, want.verts)
    _close(got.normals, want.normals)
    assert got.vertex_channels.keys() == want.vertex_channels.keys() == set("RGB")
    for c in "RGB":
        np.testing.assert_array_equal(got.vertex_channels[c], want.vertex_channels[c])
    if method == "cubes":  # the zero crossings lie on the sphere
        assert np.abs(np.linalg.norm(got.verts, axis=1) - 0.35).max() < 0.02


def test_pc_to_mesh_through_the_sdf_model(sdf):
    """The tiny SDF model end to end: the lattice in chunks of 300 queries (the last one
    padded), then marching cubes on a volume of one sign, centred first."""
    jmod, variables, model, _ = sdf
    kw = dict(batch_size=300, grid_size=8)
    vol = tmesh.sdf_volume(_cloud(TPointCloud, SDF["n_ctx"]), model, **kw)
    got = tmesh.marching_cubes_mesh(_cloud(TPointCloud, SDF["n_ctx"]), model, **kw)
    want = jmesh.marching_cubes_mesh(_cloud(JPointCloud, SDF["n_ctx"]), jmod, variables, **kw)
    assert vol.shape == (8, 8, 8) and vol.dtype == np.float32
    np.testing.assert_array_equal(got.faces, want.faces)
    # a vertex is the zero crossing v0 / (v0 - v1) along a voxel's edge (0.146 long): the
    # model's 1e-6 differences, divided by the SDF's change along the edge, reach 1.5e-5
    _close(got.verts, want.verts, 1e-4)
    with pytest.raises(ValueError):
        tmesh.mesh_from_volume(vol, _cloud(TPointCloud), method="spheres")
