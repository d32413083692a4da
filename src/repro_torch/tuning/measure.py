"""Empirical microbench harness: time candidate configs on the live backend.

The analytic model (cost_model.py) is ranking-grade, not microsecond-grade —
launch overheads, the eager rowloops and cache effects all move real
numbers.  So the tuner measures its top-k analytic candidates here and lets
the measured ordering override the model.

Two timings per candidate, matching the plan-cache split:

  * ``sample_us`` — the one-time pre-pass (CSR -> ELL [+ quantize]), paid on
    a cache miss only;
  * ``spmm_us``  — the steady-state aggregation over the prepared operand,
    paid on every request.  The tuner ranks on this.

Every measurement here is also a calibration sample: when a calibration
log is active (``repro_torch.tuning.calibration``), ``measure_config`` and
``measure_blocked_buckets`` append one (roofline terms, predicted us,
measured us) JSONL record per timing, from which the per-host
``MachineModel`` constants are fitted.

Timings are host clocks around calls that end in ``torch.cuda.synchronize()``
on the card (PyTorch returns before the device finishes, so without it the
clock would time the enqueue, not the work).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.graph import CSR, ELL, pad_csr_to_ell
from repro_torch.core.quantization import QuantizedFeatures, as_quantized
from repro_torch.tuning.cost_model import CandidateConfig, CostEstimate


def _sync() -> None:
    """Wait for the card's queued work (a no-op where CUDA never started)."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_us(fn: Callable, *args, warmup: int = 1, iters: int = 3, **kw) -> float:
    """Median wall time in microseconds of ``fn(*args, **kw)``, the card
    synchronized before and after every timed call."""
    for _ in range(warmup):
        fn(*args, **kw)
    ts = []
    for _ in range(iters):
        _sync()
        t0 = time.perf_counter()
        fn(*args, **kw)
        _sync()
        ts.append((time.perf_counter() - t0) * 1e6)
    ts.sort()
    return float(ts[len(ts) // 2])


def prepare_operand(csr: CSR, cfg: CandidateConfig,
                    features) -> tuple[ELL, QuantizedFeatures | None]:
    """The cache-miss work: sample (or pad) the ELL, optionally quantize.

    For quantizing configs, ``features`` may be a dense matrix or an
    already-quantized :class:`QuantizedFeatures`: a pre-quantized operand
    of the config's bit width is reused as-is (no second lossy pass),
    otherwise it is (re-)quantized per Eq. 1.  Float configs want the
    dense matrix — :func:`run_operand` dequantizes a stray
    ``QuantizedFeatures`` on the fly, and ``tune()`` normalizes at entry.
    """
    from repro_torch.core.aes_spmm import sample

    if cfg.strategy == "full":
        ell = pad_csr_to_ell(csr)
    else:
        ell = sample(csr, cfg.sh_width, cfg.strategy, backend=cfg.backend)
    q = as_quantized(features, cfg.quant_bits) if cfg.quant_bits is not None \
        else None
    return ell, q


def run_operand(ell: ELL, features, cfg: CandidateConfig,
                q: QuantizedFeatures | None = None):
    """The per-request work: SpMM over a prepared (cached) operand.

    Dispatch lives in :class:`repro_torch.exec.PlanExecutor`; this is a
    thin delegate kept for the tuner's (operand, config) call shape.
    """
    from repro_torch.exec import default_executor

    return default_executor().run_ell(ell, features, backend=cfg.backend,
                                      quantized=q)


def measure_blocked_buckets(bell, b, buckets, *, quantized_meta=None,
                            warmup: int = 1, iters: int = 3) -> list[float]:
    """Per-bucket microbenchmarks for a width-bucket partition.

    Times each bucket's kernel launch *in isolation* (a partial partition
    passed to ``ops.block_ell_spmm`` runs only that bucket's blocks), so the
    blocked tuner can compare candidate partitions on measured numbers
    instead of the analytic model alone — the blocked analogue of
    :func:`refine`'s top-k measurement.

    Args:
      bell: the stitched ``BlockELL`` operand.
      b: the dense operand the launch will gather — f32, or the quantized
        storage matrix when ``quantized_meta=(scale, x_min)`` is given.
      buckets: the candidate partition (``core.graph.partition_width_buckets``
        output).

    Returns one median microsecond timing per bucket, aligned with
    ``buckets``.
    """
    from repro_torch.kernels import ops

    timings = [
        time_us(ops.block_ell_spmm, bell, b, buckets=(bucket,),
                quantized_meta=quantized_meta, warmup=warmup, iters=iters)
        for bucket in buckets
    ]
    _log_bucket_measurements(bell, b, buckets, timings, quantized_meta)
    return timings


def measure_bucket_partition(bell, b, buckets, *, quantized_meta=None,
                             warmup: int = 1, iters: int = 3) -> float:
    """One end-to-end timing of a whole candidate partition — the number
    partitions are *selected* by.  Unlike summing
    :func:`measure_blocked_buckets`'s isolated launches, this pays each
    partition's real dispatch (one launch per bucket, the output
    allocation), so candidates with different bucket counts are compared
    like with like."""
    from repro_torch.kernels import ops

    return time_us(ops.block_ell_spmm, bell, b, buckets=buckets,
                   quantized_meta=quantized_meta, warmup=warmup, iters=iters)


@dataclass
class Measurement:
    config: CandidateConfig
    spmm_us: float
    sample_us: float
    estimate: CostEstimate | None = None

    @property
    def first_call_us(self) -> float:
        return self.spmm_us + self.sample_us


def _log_config_measurement(csr: CSR, features, cfg: CandidateConfig,
                            m: Measurement, feats) -> None:
    """Append this measurement's (terms, predicted, measured) pair to the
    active calibration log (no-op without one; never raises — calibration
    must not fail the tuning call it rides on)."""
    from repro_torch.tuning import calibration, cost_model
    from repro_torch.tuning import features as features_mod

    if calibration.default_log() is None:
        return
    try:
        if feats is None:
            shaped = features.q if isinstance(features, QuantizedFeatures) \
                else features
            feats = features_mod.extract_features(
                csr, feat_dim=int(shaped.shape[1]),
                with_fingerprint=False)
        terms = cost_model.roofline_terms(feats, cfg)
        if m.estimate is not None:
            pred_spmm = m.estimate.latency_us
            pred_sample = m.estimate.sample_us
        else:
            machine = calibration.calibrated_machine_model() \
                or cost_model.MachineModel()
            pred_spmm = cost_model.terms_latency_us(terms, machine)
            pred_sample = cost_model.terms_sample_us(
                terms, cfg.strategy, machine)
        graph = {"num_rows": feats.num_rows, "nnz": feats.nnz,
                 "feat_dim": feats.feat_dim,
                 "max_row_nnz": feats.max_row_nnz}
        calibration.log_measurement("spmm", cfg.to_dict(), terms,
                                    pred_spmm, m.spmm_us, graph)
        calibration.log_measurement("sample", cfg.to_dict(), terms,
                                    pred_sample, m.sample_us, graph)
    except Exception:
        pass


def _log_bucket_measurements(bell, b, buckets, timings,
                             quantized_meta) -> None:
    """Per-bucket calibration records for a width-bucket measurement pass
    (same contract as :func:`_log_config_measurement`)."""
    from repro_torch.core.graph import _np
    from repro_torch.tuning import calibration, cost_model

    if calibration.default_log() is None:
        return
    try:
        feat = int(b.shape[1])
        fb = int(b.element_size()) if quantized_meta is not None else 4
        qbits = fb * 8 if quantized_meta is not None else None
        live2d = _np(bell.live_w).reshape(
            bell.num_blocks, bell.block_rows)
        machine = calibration.calibrated_machine_model() \
            or cost_model.MachineModel()
        for (bucket_w, ids), us in zip(buckets, timings):
            slots = float(sum(bell.block_rows * bell.widths[i]
                              for i in ids))
            rows = bell.block_rows * len(ids)
            live = float(sum(live2d[i].sum() for i in ids))
            dequant = 2.0 * live * feat if qbits is not None else 0.0
            terms = cost_model.RooflineTerms(
                flops=2.0 * slots * feat + dequant,
                bytes=live * feat * fb + slots * 8 + rows * feat * 4,
                slots=slots)
            cfg = {"strategy": "block", "sh_width": int(bucket_w),
                   "backend": "cuda", "quant_bits": qbits}
            calibration.log_measurement(
                "bucket", cfg, terms,
                cost_model.terms_latency_us(terms, machine), us,
                {"num_rows": rows, "feat_dim": feat,
                 "num_blocks": len(ids)})
    except Exception:
        pass


def measure_config(csr: CSR, features, cfg: CandidateConfig, *,
                   warmup: int = 1, iters: int = 3,
                   feats=None,
                   estimate: Optional[CostEstimate] = None) -> Measurement:
    """Time one candidate end to end on the live backend.

    ``feats`` (the graph's ``GraphFeatures``) and ``estimate`` (the
    analytic :class:`CostEstimate` that nominated this candidate) are
    optional context for the calibration record; without them the features
    are re-extracted and the prediction recomputed on demand.
    """
    sample_us = time_us(lambda: prepare_operand(csr, cfg, features)[0],
                        warmup=warmup, iters=iters)
    ell, q = prepare_operand(csr, cfg, features)
    spmm_us = time_us(run_operand, ell, features, cfg, q,
                      warmup=warmup, iters=iters)
    m = Measurement(config=cfg, spmm_us=spmm_us, sample_us=sample_us,
                    estimate=estimate)
    _log_config_measurement(csr, features, cfg, m, feats)
    return m


def refine(csr: CSR, features, estimates: Sequence[CostEstimate], *,
           top_k: int = 6, warmup: int = 1, iters: int = 3,
           accuracy_weight: float = 5.0, feats=None) -> list[Measurement]:
    """Measure the analytic top-k; return them sorted by *measured score*.

    The analytic ranking decides *which* configs are worth timing; the
    measurement replaces the model's latency, but the winner is still
    picked by the full objective — measured latency x the analytic
    accuracy penalty.  Ranking on raw ``spmm_us`` alone would always crown
    the smallest-W (lowest-coverage) candidate of the measured set.
    """
    out = []
    for est in estimates[:top_k]:
        m = measure_config(csr, features, est.config,
                           warmup=warmup, iters=iters,
                           feats=feats, estimate=est)
        out.append(m)

    def measured_score(m: Measurement) -> float:
        acc = m.estimate.accuracy_proxy if m.estimate is not None else 1.0
        return m.spmm_us * (1.0 + accuracy_weight * (1.0 - acc))

    out.sort(key=measured_score)
    return out
