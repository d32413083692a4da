"""Quickstart: the AES-SpMM core API of the port.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda|cpu]

Builds a skewed graph, runs the paper's adaptive edge sampling at several
shared-memory widths, compares against the ES-SpMM baselines and the exact
aggregation, shows INT8 feature quantization, and checks that the CUDA
kernels (``backend="cuda"``) give the eager path's result — all through
the public ``repro_torch.core`` API, on ``--device`` (default ``cuda``;
on ``cpu`` each kernel wrapper runs its plain version).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import (aes_spmm, csr_from_edges, dequantize, quantize,
                              sample_csr_to_ell, sampling_rate)
from repro_torch.kernels import ref


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    rng = np.random.default_rng(0)
    n = 512
    # a power-law graph: a few hub rows exercise every strategy band
    deg = np.minimum(np.maximum((rng.pareto(1.2, n) * 24).astype(int), 1),
                     4 * n)
    src = np.concatenate([rng.integers(0, n, d) for d in deg])
    dst = np.repeat(np.arange(n), deg)
    A = csr_from_edges(src, dst, n,
                       rng.normal(size=len(src)).astype(np.float32),
                       device=device)
    B = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32)
                         ).to(device)

    print(f"graph: {n} nodes, {A.nnz} edges, max degree {int(deg.max())} "
          f"(on {device})\n")

    def rel_err(out):
        return float(torch.linalg.norm(out - exact) / torch.linalg.norm(exact))

    exact = ref.csr_spmm(A.row_ptr, A.col_ind, A.val, B)
    print(f"{'W':>6} {'rate':>7} {'sampled nnz':>12} {'rel. output err':>16}")
    for W in (8, 32, 128, 512):
        out = aes_spmm(A, B, sh_width=W, strategy="aes", backend="torch")
        ell_val, _ = sample_csr_to_ell(A.row_ptr, A.col_ind, A.val, W)
        rate = sampling_rate(A.row_ptr, W)
        print(f"{W:>6} {rate:>7.2%} {int((ell_val != 0).sum()):>12}"
              f" {rel_err(out):>16.4f}")

    print("\nstrategies at W=16 (accuracy proxy = relative output error):")
    for s in ("aes", "afs", "sfs"):
        print(f"  {s}: {rel_err(aes_spmm(A, B, sh_width=16, strategy=s)):.4f}")

    qf = quantize(B, bits=8)
    err = float((dequantize(qf) - B).abs().max())
    out_q = aes_spmm(A, B, sh_width=32, strategy="aes", quantized=qf)
    out_f = aes_spmm(A, B, sh_width=32, strategy="aes")
    print(f"\nINT8 quantization: max feature err {err:.5f} "
          f"(one step = {float(qf.scale):.5f}); "
          f"output delta {float((out_q - out_f).abs().max()):.5f}")

    # the same result through the CUDA kernels (their plain versions on
    # CPU tensors)
    out_cuda = aes_spmm(A, B, sh_width=16, strategy="aes", backend="cuda")
    out_torch = aes_spmm(A, B, sh_width=16, strategy="aes", backend="torch")
    diff = float((out_cuda - out_torch).abs().max())
    if diff >= 1e-4:
        raise SystemExit(f"cuda backend differs from torch by {diff}")
    print("cuda kernel path agrees with the torch path")


if __name__ == "__main__":
    main()
