"""Public AES-SpMM API: the paper's contribution as one composable call.

    aes_spmm(csr, features, sh_width=128,
             strategy="aes" | "afs" | "sfs" | "full",
             backend="torch" | "cuda" | "cuda_fused",
             quantized=None | QuantizedFeatures)

``strategy`` selects the paper's adaptive scheme or the ES-SpMM baselines;
``"full"`` disables sampling.  ``backend`` selects the execution path:
``"torch"`` is eager PyTorch, ``"cuda"`` the hand-written sampler and SpMM
kernels, ``"cuda_fused"`` the fused Algorithm 1 kernel (the reference
package's ``"jax"``, ``"pallas"`` and ``"pallas_fused"``).  The tuned
``strategy="auto"`` and ``granularity="block"`` come with a later slice
of the port.
"""
from __future__ import annotations

from typing import Optional

from repro_torch import obs
from repro_torch.core.graph import CSR, ELL, ell_live_widths, pad_csr_to_ell
from repro_torch.core.quantization import QuantizedFeatures, dequantize
from repro_torch.core.sampling import STRATEGIES

BACKENDS = ("torch", "cuda", "cuda_fused")


def not_ported(what: str, slice_: str = "BlockELL/tuner"):
    """The error for an option a later slice of the port brings."""
    return NotImplementedError(
        f"{what} belongs to the {slice_} slice of the port and is not "
        "ported yet (ROADMAP.md queue 1)")


def sample(csr: CSR, sh_width: int, strategy: str = "aes",
           backend: str = "torch") -> ELL:
    """Sampling pre-pass producing the ELL operand (the AES pass runs the
    sampler kernel on ``backend="cuda"``)."""
    if strategy == "full":
        ell = pad_csr_to_ell(csr)
    elif backend == "cuda" and strategy == "aes":
        from repro_torch.kernels import ops

        ell = ops.aes_sample(csr, sh_width)
    else:
        val, col = STRATEGIES[strategy](csr.row_ptr, csr.col_ind, csr.val,
                                        sh_width)
        ell = ELL(val, col, csr.num_cols)
    if obs.enabled():
        # edges the sampler kept vs. discarded on this call (dropped is
        # clamped at 0 because AES may duplicate hub edges)
        kept = int(ell_live_widths(ell.val, ell.col).sum())
        obs.count("sampler.calls")
        obs.count(f"sampler.calls.{strategy}")
        obs.count("sampler.edges_kept", kept)
        obs.count("sampler.edges_dropped", max(int(csr.nnz) - kept, 0))
    return ell


def aes_spmm(csr: CSR, features, sh_width: int = 128, *,
             strategy: str = "aes", backend: str = "torch",
             granularity: str = "graph",
             quantized: Optional[QuantizedFeatures] = None):
    """Sampled aggregation C = sample(A) @ B (paper Alg. 1 end to end).

    Args:
      csr: adjacency in CSR form.
      features: dense operand B, f32[num_nodes, feat], on the CSR's device.
      sh_width: sampling width W (ignored for strategy "full").
      strategy: "aes" | "afs" | "sfs" | "full".
      backend: "torch" | "cuda" | "cuda_fused".
      granularity: "graph" (only).
      quantized: optional quantized B.  On ``"cuda"`` it is served through
        the fused-dequant gather (``features`` re-encoded with its range);
        the other backends aggregate its Eq. 2 reconstruction.

    Returns f32[num_rows, feat].
    """
    if strategy == "auto":
        raise not_ported('strategy="auto"')
    if granularity == "block":
        raise not_ported('granularity="block"')
    if granularity != "graph":
        raise ValueError(f"unknown granularity {granularity!r} "
                         "(expected 'graph')")
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{BACKENDS})")

    if quantized is not None and backend != "cuda":
        features = dequantize(quantized)

    if backend == "cuda_fused":
        if strategy != "aes":
            raise ValueError("fused kernel implements the AES strategy only")
        from repro_torch.kernels import ops

        return ops.fused_aes_spmm(csr, features, sh_width)

    ell = sample(csr, sh_width, strategy, backend=backend)
    from repro_torch.exec import PlanExecutor

    # on the cuda backend the dequant is fused into the B-row gather;
    # requant_guard re-encodes `features` with the stored range so a
    # hidden-layer activation is never served stale int8 data
    return PlanExecutor().run_ell(
        ell, features, backend=backend,
        quantized=quantized if backend == "cuda" else None,
        requant_guard=True)
