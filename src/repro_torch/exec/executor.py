"""PlanExecutor: the owner of SpMM execution dispatch.

This slice of the port carries :meth:`PlanExecutor.run_ell`, the
global-ELL path (the CUDA kernel or the eager rowloop, float or
fused-dequant), with the range guard and the obs counters of the
reference package.  ``run_block``, ``run_plan`` and ``run_fused_layer``
come with later slices.

Range guard (``requant_guard=True``): a quantized operand stands for
exactly the matrix it was encoded from, so the operand actually passed is
re-encoded with the stored ``(x_min, x_max)`` — bit-exact for the matrix
the range came from, exact to quantization for anything inside the range,
and the float path when the range has drifted (re-encoding would clip).
"""
from __future__ import annotations

from typing import Optional

from repro_torch import obs
from repro_torch.core.quantization import (QuantizedFeatures, dequantize,
                                           requantize_within_range)


def _dtype_tag(quantized: Optional[QuantizedFeatures]) -> str:
    return "float" if quantized is None else f"int{quantized.bits}"


def _guarded_requant(quantized, features, site: str):
    """Range-guard re-encode + the counters of how often an operand rode
    the stored range, fell back to float, or got a fresh range."""
    requanted = requantize_within_range(quantized, features)
    if obs.enabled():
        obs.count("quant.requant_in_range" if requanted is not None
                  else "quant.requant_drift_fallback")
        if requanted is not None and (
                float(requanted.x_min) != float(quantized.x_min)
                or float(requanted.x_max) != float(quantized.x_max)):
            obs.count("quant.requant_range_refreshed")
        obs.count(f"quant.requant_{site}")
    return requanted


class PlanExecutor:
    """Uniform execution dispatch over prepared SpMM operands (stateless)."""

    def run_ell(self, ell, features, *, backend: str = "torch",
                quantized: Optional[QuantizedFeatures] = None,
                requant_guard: bool = False):
        """SpMM over a global fixed-width ELL operand.

        Args:
          ell: the sampled ``core.graph.ELL``.
          features: dense operand f32[nodes, feat]; a stray
            ``QuantizedFeatures`` is dequantized.
          backend: "cuda" (kernel, fused dequant when quantized) or
            "torch" (eager rowloop).
          quantized: quantized operand to serve instead of float rows.
          requant_guard: re-encode ``features`` with the quantized
            operand's stored range, falling back to float on drift.
        """
        from repro_torch.kernels import ops, ref

        if backend not in ("torch", "cuda"):
            raise ValueError(f"run_ell backend must be 'torch' or 'cuda', "
                             f"not {backend!r}")
        if isinstance(features, QuantizedFeatures):
            features = dequantize(features)
        if quantized is not None and requant_guard:
            quantized = _guarded_requant(quantized, features, "run_ell")
        with obs.trace("exec.run_ell", backend=backend,
                       dtype=_dtype_tag(quantized)):
            if obs.enabled():
                obs.count(
                    f"executor.run_ell.{backend}.{_dtype_tag(quantized)}")
            if backend == "cuda":
                if quantized is not None:
                    return ops.ell_spmm(
                        ell, quantized.q,
                        quantized_meta=(quantized.scale, quantized.x_min))
                return ops.ell_spmm(ell, features)
            x = dequantize(quantized) if quantized is not None else features
            return ref.ell_spmm_rowloop(ell.val, ell.col, x)
