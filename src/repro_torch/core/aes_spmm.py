"""Public AES-SpMM API: the paper's contribution as one composable call.

    aes_spmm(csr, features, sh_width=128,
             strategy="aes" | "afs" | "sfs" | "full" | "auto",
             backend="torch" | "cuda" | "cuda_fused",
             granularity="graph" | "block",
             quantized=None | QuantizedFeatures)

``strategy`` selects the paper's adaptive scheme or the ES-SpMM baselines;
``"full"`` disables sampling.  ``backend`` selects the execution path:
``"torch"`` is eager PyTorch, ``"cuda"`` the hand-written sampler and SpMM
kernels, ``"cuda_fused"`` the fused Algorithm 1 kernel (the reference
package's ``"jax"``, ``"pallas"`` and ``"pallas_fused"``).
``strategy="auto"`` hands the choice to ``repro_torch.tuning``: one global
config (``granularity="graph"``) or one per row block, served as a
mixed-width BlockELL by the blocked kernel (``granularity="block"``).
"""
from __future__ import annotations

from typing import Optional

from repro_torch import obs
from repro_torch.core.graph import CSR, ELL, pad_csr_to_ell
from repro_torch.core.quantization import QuantizedFeatures, dequantize
from repro_torch.core.sampling import STRATEGIES

BACKENDS = ("torch", "cuda", "cuda_fused")


def not_ported(what: str, slice_: str = "serving"):
    """The error for an option a later slice of the port brings."""
    return NotImplementedError(
        f"{what} belongs to the {slice_} slice of the port and is not "
        "ported yet (ROADMAP.md queue 1)")


def sample(csr: CSR, sh_width: int, strategy: str = "aes",
           backend: str = "torch") -> ELL:
    """Sampling pre-pass producing the ELL operand (the AES pass runs the
    sampler kernel on ``backend="cuda"``, and its ELL carries ``live_w``)."""
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
        kept = int(ell.live_widths().sum())
        obs.count("sampler.calls")
        obs.count(f"sampler.calls.{strategy}")
        obs.count("sampler.edges_kept", kept)
        obs.count("sampler.edges_dropped", max(int(csr.nnz) - kept, 0))
    return ell


def aes_spmm(csr: CSR, features, sh_width: int = 128, *,
             strategy: str = "aes", backend: str = "torch",
             granularity: str = "graph",
             quantized: Optional[QuantizedFeatures] = None,
             plan_cache=None, tune_kwargs=None):
    """Sampled aggregation C = sample(A) @ B (paper Alg. 1 end to end).

    Args:
      csr: adjacency in CSR form.
      features: dense operand B, f32[num_nodes, feat], on the CSR's device.
      sh_width: sampling width W (ignored for strategy "full"/"auto").
      strategy: "aes" | "afs" | "sfs" | "full" | "auto".
      backend: "torch" | "cuda" | "cuda_fused" (ignored for "auto": the
        tuned plan carries its own backend).
      granularity: "graph" (default) tunes one global config; "block"
        (auto only) tunes per row block and serves a mixed-width BlockELL.
      quantized: optional quantized B.  On ``"cuda"`` it is served through
        the fused-dequant gather (``features`` re-encoded with its range);
        the other backends aggregate its Eq. 2 reconstruction.  Under
        ``strategy="auto"`` it rides into a blocked plan and is ignored for
        graph granularity.
      plan_cache / tune_kwargs: auto-mode cache scope and ``tune()`` /
        ``tune_blocked()`` overrides.

    Returns f32[num_rows, feat].
    """
    if granularity not in ("graph", "block"):
        raise ValueError(f"unknown granularity {granularity!r} "
                         "(expected 'graph' or 'block')")
    if strategy == "auto":
        if isinstance(features, QuantizedFeatures):
            # the tuner wants the dense reconstruction as the serving
            # operand and the quantized matrix as the quant source
            if quantized is None:
                quantized = features
            features = dequantize(features)
        if granularity == "block":
            from repro_torch.tuning.autotune import tune_blocked

            kw = dict(tune_kwargs or {})
            if quantized is not None:
                # a pre-quantized B rides into the blocked plan (reused,
                # no second lossy pass) and serves the fused-dequant path
                kw.setdefault("quant", quantized)
            plan = tune_blocked(csr, features, cache=plan_cache, **kw)
        else:
            from repro_torch.tuning.autotune import tune

            plan = tune(csr, features, cache=plan_cache,
                        **(tune_kwargs or {}))
        return plan.run(features)
    if granularity != "graph":
        raise ValueError(
            'granularity="block" requires strategy="auto" (per-block '
            "configs are the tuner's to pick)")
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
