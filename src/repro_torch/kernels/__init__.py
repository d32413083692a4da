"""Hand-written CUDA kernels for the AES-SpMM hot paths (``csrc/``), their
wrappers, and the plain PyTorch versions they are held against."""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
