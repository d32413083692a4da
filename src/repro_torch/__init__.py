"""repro_torch: the PyTorch/CUDA port of AES-SpMM for an NVIDIA H100.

Mirrors the module names of the JAX package ``repro`` and imports nothing
from it.  Entry points run on ``"cuda"`` unless the caller passes
``device="cpu"``; the hand-written CUDA kernels live in
``repro_torch.kernels`` and are built with ``nvcc`` at first use.
"""
__version__ = "0.1.0"
