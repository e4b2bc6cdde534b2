"""The port imports no JAX (nor the JAX package, PyYAML, h5py or matplotlib), and importing
it (or running it on the CPU: a sampler run, a forward in the fully fused configuration, a
forward with the head-split attention hooks, the Point-E family's models and mesh path, a
train step and the attention ladder's entry point) builds nothing.

Runs in a fresh interpreter, so nothing the test session imported leaks in. ``nvcc`` is
made unreachable there: ``PATH`` holds only the interpreter's directory and
``CUDA_HOME`` points at a missing directory.
"""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import sys
import torch
import pcdiff_torch
import pcdiff_torch.core, pcdiff_torch.core.weights
import pcdiff_torch.diffusion, pcdiff_torch.diffusion.gaussian, pcdiff_torch.diffusion.karras
import pcdiff_torch.diffusion.sampler, pcdiff_torch.diffusion.schedules
import pcdiff_torch.models, pcdiff_torch.models.attention, pcdiff_torch.models.embeddings
import pcdiff_torch.models.encoders, pcdiff_torch.models.rin, pcdiff_torch.models.two_stream
import pcdiff_torch.models.wrapper
import pcdiff_torch.ops, pcdiff_torch.ops.flash_attention, pcdiff_torch.ops.layer_norm
import pcdiff_torch.ops.ln_dense, pcdiff_torch.ops.ln_mlp, pcdiff_torch.ops.attn_ladder
import pcdiff_torch.scripts, pcdiff_torch.scripts.attn_profile
import pcdiff_torch.core.device, pcdiff_torch.data, pcdiff_torch.data.synthetic
import pcdiff_torch.geometry, pcdiff_torch.geometry.ops
import pcdiff_torch.train, pcdiff_torch.train.ema, pcdiff_torch.train.state
import pcdiff_torch.train.step
import pcdiff_torch.core.config, pcdiff_torch.core.checkpoint, pcdiff_torch.core.logging
import pcdiff_torch.data.modelnet, pcdiff_torch.data.loader
import pcdiff_torch.geometry.fps, pcdiff_torch.geometry.ply, pcdiff_torch.geometry.point_cloud
import pcdiff_torch.utils, pcdiff_torch.utils.io, pcdiff_torch.evals, pcdiff_torch.evals.metrics
import pcdiff_torch.cli, pcdiff_torch.cli.train, pcdiff_torch.cli.sample
import pcdiff_torch.cli.evaluate, pcdiff_torch.scripts.quality
import pcdiff_torch.scripts.trained_gates, pcdiff_torch.scripts.shapes_evidence
import pcdiff_torch.train.graphs
import pcdiff_torch.evals.fid_is, pcdiff_torch.evals.npz_stream, pcdiff_torch.evals.pointnet2
import pcdiff_torch.evals.feature_extractor, pcdiff_torch.cli.evaluate_pfid
import pcdiff_torch.cli.evaluate_pis, pcdiff_torch.cli.downsample
import pcdiff_torch.geometry.fps_native, pcdiff_torch.geometry.mesh, pcdiff_torch.utils.plotting
import pcdiff_torch.models.point_e, pcdiff_torch.models.configs, pcdiff_torch.models.clip
import pcdiff_torch.models.perceiver, pcdiff_torch.models.sdf, pcdiff_torch.models.download
import pcdiff_torch.core.point_e_import, pcdiff_torch.tokenizer, pcdiff_torch.tokenizer.bpe
import pcdiff_torch.utils.marching, pcdiff_torch.utils.pc_to_mesh, pcdiff_torch.examples
import pcdiff_torch.examples.image2pointcloud, pcdiff_torch.examples.text2pointcloud
import pcdiff_torch.examples.pointcloud2mesh
from pcdiff_torch.ops import _native, flash_attention as fa, layer_norm as ln, ln_dense as ld
from pcdiff_torch.ops import attn_ladder as al, ln_mlp as lm

# a CPU forward and a CPU sampler run go through the plain versions: no build, no launch
from pcdiff_torch.core import init_params
from pcdiff_torch.diffusion import PointCloudSampler, diffusion_from_betas
from pcdiff_torch.models import BoundTwoStream, TwoStreamDenoiser
g = torch.Generator().manual_seed(0)
m = init_params(TwoStreamDenoiser(num_points=16, num_latents=4, latent_dim=32, x_dim=32,
                                  num_blocks=1, num_compute_layers=1, num_heads=4,
                                  active_modalities=("class",), device="cpu"), g)
s = PointCloudSampler([BoundTwoStream(m)], [diffusion_from_betas()], [16],
                      guidance_scale=[3.0], use_karras=[True], karras_steps=[4],
                      sigma_min=[1e-3], sigma_max=[120.0], s_churn=[0.0],
                      sampler="heun_reuse", guidance_interval=(0.1, 10.0))
out = s.sample_batch(2, {"class_labels": torch.tensor([1, 2])}, g)
assert out.shape == (2, 16, 3) and torch.isfinite(out).all()

# the fully fused configuration (whole-MLP fusion, LayerNorm kernel backend) on the CPU runs
# the plain versions too
from pcdiff_torch.models.attention import set_ln_mlp_fusion
set_ln_mlp_fusion("on")
ln.set_layernorm_backend("kernel")
with torch.no_grad():
    eps, _ = m(torch.zeros(2, 16, 3), torch.tensor([1, 500]), class_labels=torch.tensor([1, 2]))
assert torch.isfinite(eps).all()
set_ln_mlp_fusion("off")
ln.set_layernorm_backend("auto")

# the head-split attention hooks on the CPU run K7's plain version
hooked = TwoStreamDenoiser(num_points=16, num_latents=4, latent_dim=32, x_dim=32,
                           num_blocks=1, num_compute_layers=1, num_heads=4,
                           active_modalities=("class",), device="cpu",
                           **{f"{s}_attention_fn": fa.fused_attention
                              for s in ("read", "write", "compute")})
hooked.load_state_dict(m.state_dict())
with torch.no_grad():
    eps, _ = hooked(torch.zeros(2, 16, 3), torch.tensor([1, 500]),
                    class_labels=torch.tensor([1, 2]))
assert torch.isfinite(eps).all()

import numpy as np

# the Point-E family on the CPU: a tiny grid denoiser, the SDF model's mesh path and both
# CLIP towers run the plain versions (K1 at head dim 64, K3 past C = 256 included)
from pcdiff_torch.models.clip import CLIPConfig, CLIPModel
from pcdiff_torch.models.configs import MODEL_CONFIGS, model_from_config
from pcdiff_torch.utils.pc_to_mesh import marching_cubes_mesh
from pcdiff_torch.geometry.point_cloud import PointCloud
pe = init_params(model_from_config(MODEL_CONFIGS["upsample"], layers=1, width=320, heads=5,
                                   n_ctx=8, cond_ctx=4, grid_size=2, device="cpu"), g)
with torch.no_grad():
    out = pe(torch.zeros(2, 8, 6), torch.tensor([1, 500]), low_res=torch.zeros(2, 4, 6))
assert out.shape == (2, 8, 12) and torch.isfinite(out).all()
sdf = init_params(model_from_config(MODEL_CONFIGS["sdf"], encoder_layers=1, decoder_layers=1,
                                    device="cpu"), g)
cloud = PointCloud(coords=np.random.default_rng(1).uniform(-0.4, 0.4, (64, 3)).astype(np.float32),
                   channels={})
assert len(marching_cubes_mesh(cloud, sdf, batch_size=100, grid_size=6).verts) >= 0
clip = init_params(CLIPModel(CLIPConfig(embed_dim=16, image_resolution=28, vision_width=64,
                                        vision_layers=1, vision_patch=14, text_width=64,
                                        text_layers=1, text_heads=1, vocab_size=32,
                                        context_length=6), device="cpu"), g)
with torch.no_grad():
    assert clip.encode_image(torch.zeros(1, 28, 28, 3)).shape == (1, 16)
    assert clip.encode_text(torch.tensor([[1, 5, 31, 0, 0, 0]])).shape == (1, 16)

# the ladder's entry point on the CPU runs the plain rungs
from pcdiff_torch.scripts import attn_profile
attn_profile.main(["--device", "cpu"])

# a CPU train step goes through the plain backward versions
from pcdiff_torch.train import create_train_state, make_train_step
state = create_train_state(m, total_steps=10, device="cpu")
step = make_train_step(m, diffusion_from_betas(), self_conditioning_prob=1.0, device="cpu")
batch = {"target": np.random.default_rng(0).uniform(-0.5, 0.5, (2, 16, 3)).astype(np.float32),
         "class_labels": np.array([1, 2])}
assert torch.isfinite(step(state, batch, g, True)["loss"])

bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "pcdiff", "yaml", "h5py",
                                    "matplotlib"))
assert not bad, bad
assert _native._libs == {} and _native.build_seconds == {}, "a kernel was built"
assert fa.launches == 0 and ld.launches == 0
assert fa.bwd_launches == 0 and ld.bwd_launches == 0
assert lm.launches == 0 and ln.launches == 0 and ln.bwd_launches == 0
assert fa.k7_launches == 0 and al.launches == 0
print("ok")
"""


def test_port_imports_no_jax_and_builds_nothing():
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    env.update(PATH=str(Path(sys.executable).parent), CUDA_HOME=str(ROOT / "no-cuda-here"),
               PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
