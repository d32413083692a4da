"""The yardstick's arithmetic: bytes and operations of a forward pass, the
least time the card could take for them, and the card's published peaks.

Each aggregation ``C = sample(A) @ B`` over ``rows`` rows, ``live`` live
slots and an operand of width ``feat`` needs at least:

  * bytes: the row lengths (``4 * (rows + 1)``: row_ptr, or the live
    widths the gather reads instead), the live entries (``col`` and
    ``val``, 8 bytes a slot), the operand read once at its stored width
    (``rows * feat * itemsize``, plus 8 bytes of Eq. 2 constants where it
    is quantized) and the float32 output written once
    (``4 * rows * feat``);
  * operations: ``2 * live * feat`` (a multiply and an add a slot and
    feature).

A dense transform of ``rows`` rows from ``k`` to ``m`` features is
``2 * rows * k * m`` operations.  Bias, activation, sampling and
quantization are not counted.
"""
from __future__ import annotations

#: Published peaks (NVIDIA's data sheet, H100 SXM, dense): HBM bytes/s and
#: float32 operations/s outside the tensor cores.
PEAKS = {"H100": {"bytes_per_s": 3.35e12, "flops_f32": 67e12}}


def peak(kind: str):
    """The peaks of the card named ``kind``, or None for another device."""
    for key, value in PEAKS.items():
        if key in kind:
            return value
    return None


def agg_bytes(rows: int, live: int, feat: int, itemsize: int) -> int:
    consts = 8 if itemsize < 4 else 0
    return 4 * (rows + 1) + 8 * live + rows * feat * itemsize + consts \
        + 4 * rows * feat


def agg_flops(live: int, feat: int) -> int:
    return 2 * live * feat


def gemm_flops(rows: int, k: int, m: int) -> int:
    return 2 * rows * k * m


def least_s(n_bytes: int, flops: int, pk: dict) -> float:
    """The larger of bytes over peak bandwidth and operations over peak
    float32 rate."""
    return max(n_bytes / pk["bytes_per_s"], flops / pk["flops_f32"])


def forward_counts(ref_model, cfg: dict, live: int, quant_bits, kind: str):
    """``{"agg_least_s", "model_flops"}`` of one forward pass of ``cfg``'s
    model (``ref_model`` its reference module) over ``live`` live slots an
    aggregation; ``agg_least_s`` is None on a device with no peaks."""
    rows = int(cfg["nodes"])
    itemsize = 4 if not quant_bits else (1 if quant_bits <= 8 else 2)
    pk = peak(kind)
    least, flops = 0.0, 0
    for feat in ref_model.aggregations(cfg):
        f = agg_flops(live, feat)
        flops += f
        if pk:
            least += least_s(agg_bytes(rows, live, feat, itemsize), f, pk)
    for k, m in ref_model.gemms(cfg):
        flops += gemm_flops(rows, k, m)
    return {"agg_least_s": least if pk else None, "model_flops": flops,
            "peak": pk}
