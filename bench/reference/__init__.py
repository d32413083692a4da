"""The benchmark's plain reference: the logits of a configuration's model
on the benchmark's own graph, features and weights, in plain PyTorch.

It imports nothing of the program and takes nothing the program made: it
samples the CSR again with its own frozen copy of AES (:mod:`.aes`),
quantizes the features again (:mod:`.quant`), and runs the model's
equations (one module a model, named as the configuration's ``model``).

``precision="f64"`` is the reference: float64 throughout, TF32 off.
``precision="tf32"`` is the control of a float32 configuration: float32
with every product's inputs rounded to TF32 (10 mantissa bits, round to
nearest, ties away, as the tensor cores take them) and summed in float32.
A quantized configuration's control is the reference at fewer ``bits``.
Rows are aggregated in blocks of at most :data:`BLOCK_BYTES` of gathered
operand, so the reference fits beside the program's data.
"""
from __future__ import annotations

import importlib

import torch

from bench.reference import aes, quant

BLOCK_BYTES = 1 << 30


def model(name: str):
    """The reference module of model ``name`` (``bench/reference/<name>.py``)."""
    return importlib.import_module(f"bench.reference.{name}")


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def aggregate(row_ptr, col, val, h, width: int, rnd) -> torch.Tensor:
    """``sample(A) @ h`` in ``h``'s dtype: rows in blocks, each row's live
    slots gathered and summed by a batched product."""
    n = row_ptr.numel() - 1
    nnz = (row_ptr[1:] - row_ptr[:-1]).long()
    n_per, cnt = aes.strategy(nnz, width)
    out = torch.empty(n, h.shape[1], dtype=h.dtype, device=h.device)
    rows = max(1, BLOCK_BYTES // (width * max(h.shape[1], 1)
                                  * h.element_size()))
    for r0 in range(0, n, rows):
        r1 = min(n, r0 + rows)
        v, c, _ = aes.sample_rows(row_ptr, col, val, nnz, n_per, cnt, r0, r1,
                                  width)
        v = rnd(v.to(h.dtype))
        out[r0:r1] = torch.bmm(v.unsqueeze(1), h[c]).squeeze(1)
    return out


def logits(cfg: dict, row_ptr, col, val, x32, params: dict, *,
           quant_bits=None, precision: str = "f64") -> torch.Tensor:
    """Logits ``[nodes, classes]`` of ``cfg``'s model over the CSR
    ``(row_ptr, col, val)`` (the normalized adjacency the model reads) and
    float32 features ``x32``, with ``quant_bits``-bit features if set."""
    if precision == "f64":
        dtype, rnd = torch.float64, (lambda t: t)
    elif precision == "tf32":
        dtype, rnd = torch.float32, tf32
    else:
        raise ValueError(f"unknown precision {precision!r}")
    width = int(cfg["sh_width"])
    p = {k: v.to(dtype) for k, v in params.items()}
    if quant_bits:
        x, stored = quant.quantize_features(x32, quant_bits, dtype)
    else:
        x, stored = x32.to(dtype), None

    def agg(h):
        if stored is not None:
            h = quant.through_range(h, stored, quant_bits)
        return aggregate(row_ptr, col, val, rnd(h), width, rnd)

    def mm(a, b):
        return rnd(a) @ rnd(b)

    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            return model(cfg["model"]).forward(agg, mm, x, p)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
