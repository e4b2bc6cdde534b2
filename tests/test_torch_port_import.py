"""The port imports no JAX, and importing it (or running it on the CPU: a sampler run, a
forward in the fully fused configuration and a train step) builds nothing.

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
import pcdiff_torch.ops.ln_dense, pcdiff_torch.ops.ln_mlp
import pcdiff_torch.core.device, pcdiff_torch.data, pcdiff_torch.data.synthetic
import pcdiff_torch.geometry, pcdiff_torch.geometry.ops
import pcdiff_torch.train, pcdiff_torch.train.ema, pcdiff_torch.train.state
import pcdiff_torch.train.step
from pcdiff_torch.ops import _native, flash_attention as fa, layer_norm as ln, ln_dense as ld
from pcdiff_torch.ops import ln_mlp as lm

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

# a CPU train step goes through the plain backward versions
import numpy as np
from pcdiff_torch.train import create_train_state, make_train_step
state = create_train_state(m, total_steps=10, device="cpu")
step = make_train_step(m, diffusion_from_betas(), self_conditioning_prob=1.0, device="cpu")
batch = {"target": np.random.default_rng(0).uniform(-0.5, 0.5, (2, 16, 3)).astype(np.float32),
         "class_labels": np.array([1, 2])}
assert torch.isfinite(step(state, batch, g, True)["loss"])

bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax", "pcdiff"))
assert not bad, bad
assert _native._libs == {} and _native.build_seconds == {}, "a kernel was built"
assert fa.launches == 0 and ld.launches == 0
assert fa.bwd_launches == 0 and ld.bwd_launches == 0
assert lm.launches == 0 and ln.launches == 0 and ln.bwd_launches == 0
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
