"""pcdiff_torch — the PyTorch and CUDA port of :mod:`pcdiff` for NVIDIA Hopper (H100).

The package mirrors ``pcdiff``'s module paths and names, so every module has its JAX
counterpart at the same path: :mod:`pcdiff_torch.ops` (hand-written CUDA kernels with
their plain PyTorch versions), :mod:`pcdiff_torch.models` (the two-stream denoiser and its
encoders), :mod:`pcdiff_torch.diffusion` (the Gaussian process, Karras solvers and the
sampler) and :mod:`pcdiff_torch.core` (weights from the JAX package's parameter trees).
It imports no JAX. The CUDA kernels are built from ``csrc/`` at their first launch, never
at import.
"""

__version__ = "0.1.0"
