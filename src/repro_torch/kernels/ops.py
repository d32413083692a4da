"""Public wrappers over the kernels, on the graph containers.

The signatures and output shapes are those of the reference package's
``kernels/ops.py``.  The Hopper kernels mask ragged rows, features and CSR
tails themselves, so nothing is padded here.  CPU tensors take each
kernel's plain version, CUDA tensors the kernel.
"""
from __future__ import annotations

from repro_torch.core.graph import CSR, ELL, BlockELL, partition_width_buckets
from repro_torch.kernels import aes_sample as _sample_mod
from repro_torch.kernels import block_ell_spmm as _block_mod
from repro_torch.kernels import dequant as _dequant_mod
from repro_torch.kernels import ell_spmm as _ell_mod
from repro_torch.kernels import fused_layer as _layer_mod
from repro_torch.kernels import fused_spmm as _fused_mod

#: The launch-counted kernel wrappers, by kernel name.
KERNELS = {
    "ell_spmm": _ell_mod.ell_spmm,
    "aes_sample": _sample_mod.aes_sample,
    "fused_aes_spmm": _fused_mod.fused_aes_spmm,
    "fused_layer": _layer_mod.fused_layer,
    "dequantize": _dequant_mod.dequantize,
    "block_ell_spmm": _block_mod.block_ell_spmm,
}

# The reference package's bound on a fused layer's F and H (there the
# VMEM budget of the aggregation tile, the weights and the B rows).  The
# Hopper kernel tiles F and H and has no such limit; the port keeps the
# reference's bound so that both packages take the same layers.
_FUSED_LAYER_MAX_DIM = 2048


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def ell_spmm(ell: ELL, b, live_w=None, *, quantized_meta=None):
    """ELL SpMM ``C[r] = sum_k ell.val[r, k] * B[ell.col[r, k]]``.

    Args:
      ell: sampled operand (dead slots zeroed, live slots a prefix).
      b: dense operand ``[num_nodes, feat]`` — f32, or uint8/uint16 when
        ``quantized_meta`` is given.
      live_w: optional int32[rows] live-prefix lengths; else
        ``ell.live_w``, else decoded from the zero sentinel.
      quantized_meta: ``(scale, x_min)`` enables the fused-dequant gather.

    Returns f32[rows, feat].
    """
    if live_w is None:
        live_w = ell.live_widths()
    return _ell_mod.ell_spmm(ell.val.contiguous(), ell.col.contiguous(),
                             live_w.contiguous(), b.contiguous(),
                             quantized_meta=quantized_meta)


def block_ell_spmm(bell: BlockELL, b, *, quantized_meta=None, buckets=None):
    """Blocked SpMM over a mixed-width BlockELL, one kernel launch per
    width bucket.

    Args:
      bell: the stitched operand (see ``core.graph.BlockELL``).
      b: dense operand ``[num_nodes, feat]`` — f32, or uint8/uint16 when
        ``quantized_meta`` is given.
      quantized_meta: ``(scale, x_min)`` enables the fused-dequant gather.
      buckets: width-bucket partition ``((bucket_w, block_ids), ...)``
        (``core.graph.partition_width_buckets``; a tuned ``BlockedPlan``
        passes its own).  Default: computed from ``bell.widths``.  A
        partial partition is allowed — the rows of the blocks it omits
        stay zero — which the tuner uses to time one bucket alone.

    Returns f32[bell.num_rows, feat].
    """
    if buckets is None:
        buckets = partition_width_buckets(bell.widths)
    return _block_mod.block_ell_spmm(
        bell.val, bell.col, bell.live_w, b.contiguous(), widths=bell.widths,
        block_rows=bell.block_rows, num_rows=bell.num_rows, buckets=buckets,
        quantized_meta=quantized_meta)


def prepare_block_ell(bell: BlockELL, buckets=None) -> None:
    """Copy the blocked kernel's launch table for ``bell`` and ``buckets``
    (as :func:`block_ell_spmm` takes them) to the card now.  The first
    launch on an operand otherwise copies it from the host, which waits
    for the card; a serving loop warms its plans here so that its dispatch
    never waits.  A no-op for a BlockELL on the CPU."""
    if bell.val.device.type != "cuda":
        return
    if buckets is None:
        buckets = partition_width_buckets(bell.widths)
    _block_mod._device_table(
        bell.val, tuple(int(w) for w in bell.widths), bell.block_rows,
        tuple(tuple(int(i) for i in ids) for _, ids in buckets))


def aes_sample(csr: CSR, sh_width: int) -> ELL:
    """AES sampling pre-pass: CSR -> ELL(width=sh_width), dead slots
    zeroed, carrying its live widths (written by the kernel on the card)."""
    val, col, live_w = _sample_mod.aes_sample(csr.row_ptr, csr.col_ind,
                                              csr.val, sh_width)
    return ELL(val, col, csr.num_cols, live_w)


def fused_aes_spmm(csr: CSR, b, sh_width: int):
    """Single-kernel AES-SpMM (paper Alg. 1): sample + multiply fused, no
    ELL materialized.  Returns f32[num_rows, feat]."""
    return _fused_mod.fused_aes_spmm(csr.row_ptr, csr.col_ind, csr.val,
                                     b.contiguous(), sh_width)


def fused_layer_spmm(ell: ELL, b, w, bias, live_w=None, *, relu: bool = True,
                     quantized_meta=None):
    """Fused GNN layer: gather + (dequant) + SpMM + dense transform +
    activation in one launch; the aggregation never reaches device memory.

    Args:
      ell: sampled operand (same contract as :func:`ell_spmm`).
      b: dense operand ``[num_nodes, feat]`` — f32, or uint8/uint16 when
        ``quantized_meta`` is given.
      w: layer weights f32[feat, hidden].
      bias: layer bias f32[hidden].
      live_w: optional int32[rows] live-prefix lengths; else
        ``ell.live_w``, else decoded from the zero sentinel.
      relu: apply ReLU after the bias add (False for a logits layer).
      quantized_meta: ``(scale, x_min)`` enables the fused-dequant gather.

    Returns f32[rows, hidden] with
    ``out[r] = act(sum_k ell.val[r, k] * B[ell.col[r, k]] @ W + bias)``.
    """
    feat, hidden = b.shape[1], w.shape[1]
    if w.shape[0] != feat:
        raise ValueError(
            f"weight rows {w.shape[0]} != operand features {feat}")
    if feat > _FUSED_LAYER_MAX_DIM or hidden > _FUSED_LAYER_MAX_DIM:
        raise ValueError(
            f"fused layer dims F={feat}, H={hidden} exceed the shared-memory "
            f"budget ({_FUSED_LAYER_MAX_DIM}); use the unfused path")
    if live_w is None:
        live_w = ell.live_widths()
    return _layer_mod.fused_layer(
        ell.val.contiguous(), ell.col.contiguous(), live_w.contiguous(),
        b.contiguous(), w.contiguous(), bias.reshape(-1).contiguous(),
        relu=relu, quantized_meta=quantized_meta)


def dequantize(q, scale, x_min, *, bits: int = 8, out=None):
    """Dequantization (paper Eq. 2): ``q * scale + x_min``.

    Args:
      q: quantized matrix uint8/uint16[n, f].
      scale / x_min: the affine dequant constants: two scalars, or two f32
        ``[S]`` tables on ``q``'s device for ``S`` equal row segments of
        ``q`` (segment ``s`` through entry ``s``), ``S`` dividing ``n``.
      bits: source bit width (8 or 16).
      out: optional contiguous f32[n, f] to write into.

    Returns f32[n, f].
    """
    return _dequant_mod.dequantize(q.contiguous(), scale, x_min, bits=bits,
                                   out=out)
