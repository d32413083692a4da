"""Fused GNN layer: ``out[r] = act(sum_{k < live_w[r]} val[r, k] *
B[col[r, k]] @ W + bias)`` in one kernel, on float32 B or on uint8/uint16
B with Eq. 2 applied in the gather; the ``[rows, F]`` aggregation stays
in shared memory and the transform runs on the tensor cores in 3xTF32.

The kernel (``csrc/fused_layer.cu``) replaces the Pallas TPU kernel
``src/repro/kernels/fused_layer.py:fused_layer``; the source says what
bounds it and what its design does about that.  :func:`fused_layer_plain`
is its plain PyTorch version, which the wrapper runs for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ell_spmm import (_QUANT_DTYPES, _eq2_constants,
                                          ell_spmm_plain)

__all__ = ["MAX_SHARED_BYTES", "fused_layer", "fused_layer_plain"]

#: Shared memory one Hopper block may use (opt-in maximum).  The wrapper
#: refuses an F whose 4-row f32 tile would not fit in it, its contract
#: since the first kernel; the kernel itself gathers F in 128-feature
#: chunks and streams W in 128 x 64 tiles.
MAX_SHARED_BYTES = 232448

_P, _I = ctypes.c_void_p, ctypes.c_int
# (val, col, live_w, b, w, bias, out, rows, width, feat, hidden, relu
#  [, &scale, &x_min], stream)
_FUNCTIONS = {torch.float32: "fused_layer_f32", torch.uint8: "fused_layer_u8",
              torch.uint16: "fused_layer_u16"}
_SIGNATURES = {fn: [_P] * 7 + [_I] * 5 + [_P] * (1 if dt == torch.float32
                                                 else 3)
               for dt, fn in _FUNCTIONS.items()}


def fused_layer_plain(val, col, live_w, b, w, bias, *, relu: bool = True,
                      quantized_meta=None):
    """Plain PyTorch version of the kernel: the live-prefix SpMM, then
    ``@ w + bias`` and the activation as separate ops."""
    h = ell_spmm_plain(val, col, live_w, b, quantized_meta) @ w + bias
    return torch.relu(h) if relu else h


def fused_layer(val: torch.Tensor, col: torch.Tensor, live_w: torch.Tensor,
                b: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
                relu: bool = True, quantized_meta=None) -> torch.Tensor:
    """One GNN layer over the live prefix of each row, in one launch.

    Args:
      val / col: f32 / int32 ``[rows, W]``; ``col`` in ``[0, b.shape[0])``.
      live_w: int32 ``[rows]``, slots summed per row.
      b: ``[nodes, F]`` f32, or uint8/uint16 with ``quantized_meta``.
      w / bias: f32 ``[F, H]`` / ``[H]``.
      relu: ReLU after the bias add (False for a logits layer).
      quantized_meta: ``(scale, x_min)`` of Eq. 2 for a quantized ``b``:
        f32 scalar tensors (read by the kernel where they lie) or floats.

    Returns f32 ``[rows, H]``.  CPU tensors run :func:`fused_layer_plain`;
    CUDA tensors launch the kernel.
    """
    req = _build.require
    req(val.dim() == 2 and val.dtype == torch.float32,
        "val must be f32[rows, W]")
    req(col.shape == val.shape and col.dtype == torch.int32,
        "col must be int32 and shaped like val")
    req(live_w.shape == (val.shape[0],) and live_w.dtype == torch.int32,
        "live_w must be int32[rows]")
    req(b.dim() == 2, "b must be [nodes, F]")
    if quantized_meta is None:
        req(b.dtype == torch.float32, f"b must be float32 (got {b.dtype})")
    else:
        req(b.dtype in _QUANT_DTYPES,
            f"a quantized b must be uint8 or uint16 (got {b.dtype})")
    feat = b.shape[1]
    req(w.dim() == 2 and w.shape[0] == feat and w.dtype == torch.float32,
        f"w must be f32[F={feat}, H]")
    hidden = w.shape[1]
    req(bias.shape == (hidden,) and bias.dtype == torch.float32,
        f"bias must be f32[H={hidden}]")
    req(4 * ((feat + 3) // 4 * 4) * 4 <= MAX_SHARED_BYTES,
        f"F={feat} does not fit the kernel's aggregation tile in "
        f"{MAX_SHARED_BYTES} bytes of shared memory")
    for name, t in (("val", val), ("col", col), ("live_w", live_w), ("b", b),
                    ("w", w), ("bias", bias)):
        req(t.is_contiguous(), f"{name} must be contiguous")
    if _build.route(val, col, live_w, b, w, bias) == "cpu":
        return fused_layer_plain(val, col, live_w, b, w, bias, relu=relu,
                                 quantized_meta=quantized_meta)

    rows, width = val.shape
    out = torch.empty((rows, hidden), dtype=torch.float32, device=val.device)
    if rows == 0 or hidden == 0:
        return out
    lib = _build.load("fused_layer", _SIGNATURES)
    fn = getattr(lib, _FUNCTIONS[b.dtype])
    args = [_build.ptr(t) for t in (val, col, live_w, b, w, bias, out)]
    args += [rows, width, feat, hidden, int(bool(relu))]
    if quantized_meta is not None:
        meta = _eq2_constants(quantized_meta, val.device)  # alive to launch
        args += [_build.ptr(t) for t in meta]
    with torch.cuda.device(val.device):
        code = fn(*args, _build.stream_handle(val.device))
    _build.check(lib, code, "fused_layer")
    fused_layer.launches += 1
    return out


fused_layer.launches = 0
