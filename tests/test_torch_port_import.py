"""The port imports no JAX, and importing it (or running it on the CPU) builds nothing.

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
import pcdiff_torch.ops.ln_dense
from pcdiff_torch.ops import _native, flash_attention as fa, ln_dense as ld

# a CPU forward and a CPU sampler run go through the plain versions: no build, no launch
from pcdiff_torch.core import init_params
from pcdiff_torch.diffusion import PointCloudSampler, diffusion_from_betas
from pcdiff_torch.models import BoundTwoStream, TwoStreamDenoiser
g = torch.Generator().manual_seed(0)
m = init_params(TwoStreamDenoiser(num_points=16, num_latents=4, latent_dim=32, x_dim=32,
                                  num_blocks=1, num_compute_layers=1, num_heads=4,
                                  active_modalities=("class",)), g)
s = PointCloudSampler([BoundTwoStream(m)], [diffusion_from_betas()], [16],
                      guidance_scale=[3.0], use_karras=[True], karras_steps=[4],
                      sigma_min=[1e-3], sigma_max=[120.0], s_churn=[0.0],
                      sampler="heun_reuse", guidance_interval=(0.1, 10.0))
out = s.sample_batch(2, {"class_labels": torch.tensor([1, 2])}, g)
assert out.shape == (2, 16, 3) and torch.isfinite(out).all()

bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "flax", "pcdiff"))
assert not bad, bad
assert _native._libs == {} and _native.build_seconds == {}, "a kernel was built"
assert fa.launches == 0 and ld.launches == 0
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
