"""Analytic latency / accuracy-proxy model over candidate SpMM configs.

Same napkin-math discipline as ``benchmarks/analytic.py``: per-config FLOPs
and HBM bytes from the sparsity statistics, rooflined against a
``MachineModel`` (``time = max(flops/peak, bytes/bw) + overhead``).  The
model's job is *ranking*, not absolute microseconds — ``measure.py`` refines
the top of the ranking on the live backend, so only the ordering of
clearly-separated candidates must be right.

Latency structure per strategy:

  * sampled strategies (aes/afs/sfs) touch ``rows * W`` ELL slots; per-slot
    index cost differs (sfs: boundary check only; afs: one divide per
    element; aes: hash + strided scatter) — the paper's §2.4 cost ordering;
  * ``full`` pads every row to ``max_row_nnz`` — exact, but on skewed graphs
    the pad width explodes (the motivation figure), which is precisely what
    the model must see to prefer sampling on heavy-tailed inputs;
  * quantized features cut the gather's bytes by 4x (int8) / 2x (int16) at
    a small dequant cost (fused into the gather on the cuda backend).

Accuracy proxy: edge coverage ``sum_r min(nnz_r, W) / nnz`` shaped by a
concave response (GNN accuracy degrades slowly in dropped edges — paper
Fig. 6), a strategy-quality factor (SFS's window is biased, paper §2.4),
and a quantization penalty (paper: <= 0.3% for int8).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterable, Optional, Sequence

from repro_torch.tuning.features import GraphFeatures

STRATEGIES = ("aes", "afs", "sfs", "full")
BACKENDS = ("torch", "cuda")
DEFAULT_WIDTHS = (16, 32, 64, 128, 256)


@dataclass(frozen=True, order=True)
class CandidateConfig:
    """One point in the tuner's search grid (hashable, JSON-friendly)."""

    strategy: str                      # aes | afs | sfs | full
    sh_width: int                      # ignored (0) for strategy="full"
    backend: str = "torch"             # torch | cuda  (ELL execution path)
    quant_bits: Optional[int] = None   # None | 8 | 16

    def key(self) -> str:
        q = "f32" if self.quant_bits is None else f"int{self.quant_bits}"
        return f"{self.strategy}-w{self.sh_width}-{self.backend}-{q}"

    def to_dict(self) -> dict:
        return {"strategy": self.strategy, "sh_width": self.sh_width,
                "backend": self.backend, "quant_bits": self.quant_bits}

    @classmethod
    def from_dict(cls, d: dict) -> "CandidateConfig":
        return cls(strategy=d["strategy"], sh_width=int(d["sh_width"]),
                   backend=d.get("backend", "torch"),
                   quant_bits=d.get("quant_bits"))


@dataclass(frozen=True)
class MachineModel:
    """Roofline constants.  Defaults are deliberately generic — ranking only
    depends on their ratios, and measurement recalibrates the winners.
    ``repro_torch.tuning.calibration`` fits all of them per host from logged
    (predicted, measured) pairs; ``rank()`` picks the fitted model up
    automatically once enough records exist."""

    peak_flops: float = 2.0e12          # FLOP/s the SpMM path can sustain
    hbm_bw: float = 4.0e11              # bytes/s
    launch_overhead_us: float = 30.0    # per kernel call
    # per-ELL-slot sampling cost in ns (index math; paper §2.4 ordering)
    sample_cost_ns: dict = field(default_factory=lambda: {
        "sfs": 0.5, "afs": 1.5, "aes": 1.0, "full": 0.25})

    def to_dict(self) -> dict:
        return {"peak_flops": self.peak_flops, "hbm_bw": self.hbm_bw,
                "launch_overhead_us": self.launch_overhead_us,
                "sample_cost_ns": dict(self.sample_cost_ns)}

    @classmethod
    def from_dict(cls, d: dict) -> "MachineModel":
        return cls(peak_flops=float(d["peak_flops"]),
                   hbm_bw=float(d["hbm_bw"]),
                   launch_overhead_us=float(d["launch_overhead_us"]),
                   sample_cost_ns={k: float(v)
                                   for k, v in d["sample_cost_ns"].items()})


@dataclass(frozen=True)
class RooflineTerms:
    """The machine-independent workload terms the roofline multiplies: the
    same triple feeds ``predict()`` and the calibration log, so a fitted
    ``MachineModel`` re-prices exactly what the analytic one priced."""

    flops: float     # SpMM + (optional) fused-dequant FLOPs
    bytes: float     # HBM bytes moved: B-row gather + operand + output
    slots: float     # padded ELL slots (what the sampling pre-pass costs by)

    def to_dict(self) -> dict:
        return {"flops": self.flops, "bytes": self.bytes, "slots": self.slots}

    @classmethod
    def from_dict(cls, d: dict) -> "RooflineTerms":
        return cls(flops=float(d["flops"]), bytes=float(d["bytes"]),
                   slots=float(d["slots"]))


@dataclass(frozen=True)
class CostEstimate:
    config: CandidateConfig
    latency_us: float        # steady-state SpMM over the (cached) operand
    sample_us: float         # one-time sampling pre-pass (amortized by cache)
    accuracy_proxy: float    # in (0, 1]; 1.0 == exact aggregation
    score: float             # lower is better

    def as_row(self) -> str:
        return (f"{self.config.key():>24} lat={self.latency_us:9.1f}us "
                f"sample={self.sample_us:8.1f}us acc~{self.accuracy_proxy:.3f} "
                f"score={self.score:9.1f}")


def _ell_width(feats: GraphFeatures, cfg: CandidateConfig) -> int:
    return feats.max_row_nnz if cfg.strategy == "full" else cfg.sh_width


def roofline_terms(feats: GraphFeatures,
                   cfg: CandidateConfig) -> RooflineTerms:
    """(flops, bytes, slots) one steady-state SpMM of ``cfg`` executes over
    ``feats`` — machine-independent, so the calibration fitter can re-price
    logged measurements under any candidate ``MachineModel``."""
    W = max(_ell_width(feats, cfg), 1)
    rows, F = feats.num_rows, feats.feat_dim
    slots = rows * W                       # padded ELL slots the SpMM scans
    live = feats.sum_min_nnz(W)            # slots that carry an edge

    flops = 2.0 * slots * F
    feat_bytes = 4 if cfg.quant_bits is None else max(cfg.quant_bits // 8, 1)
    gather_bytes = live * F * feat_bytes   # B-row fetches (the hot loop)
    operand_bytes = slots * 8              # val f32 + col i32
    out_bytes = rows * F * 4
    dequant_flops = 2.0 * live * F if cfg.quant_bits is not None else 0.0
    return RooflineTerms(
        flops=flops + dequant_flops,
        bytes=gather_bytes + operand_bytes + out_bytes,
        slots=float(slots))


def terms_latency_us(terms: RooflineTerms, machine: MachineModel) -> float:
    """Roofline latency for one steady-state SpMM over ``terms``."""
    busy_s = max(terms.flops / machine.peak_flops,
                 terms.bytes / machine.hbm_bw)
    return busy_s * 1e6 + machine.launch_overhead_us


def terms_sample_us(terms: RooflineTerms, strategy: str,
                    machine: MachineModel) -> float:
    """Latency of the one-time sampling pre-pass over ``terms.slots``."""
    cost_ns = machine.sample_cost_ns.get(strategy, 1.0)
    return terms.slots * cost_ns * 1e-3 + machine.launch_overhead_us


def predict(feats: GraphFeatures, cfg: CandidateConfig,
            machine: MachineModel | None = None,
            accuracy_weight: float = 5.0) -> CostEstimate:
    """Analytic (latency, accuracy proxy, score) for one candidate."""
    m = machine or MachineModel()
    W = max(_ell_width(feats, cfg), 1)

    terms = roofline_terms(feats, cfg)
    # --- steady-state SpMM over the ELL operand --------------------------
    latency_us = terms_latency_us(terms, m)
    # --- one-time sampling pre-pass (skipped on plan-cache hits) ---------
    sample_us = terms_sample_us(terms, cfg.strategy, m)

    # --- accuracy proxy --------------------------------------------------
    coverage = feats.covered_edge_frac(W)
    quality = {"aes": 0.97, "afs": 1.0, "sfs": 0.80, "full": 1.0}[cfg.strategy]
    if cfg.strategy == "full" or coverage >= 1.0:
        acc = 1.0
    else:
        # concave response: dropping the last edges costs little (Fig. 6)
        acc = (coverage ** 0.25) * (quality + (1 - quality) * coverage)
    if cfg.quant_bits is not None:
        acc *= 1.0 - (0.003 if cfg.quant_bits <= 8 else 0.0005)

    score = latency_us * (1.0 + accuracy_weight * (1.0 - acc))
    return CostEstimate(config=cfg, latency_us=latency_us,
                        sample_us=sample_us, accuracy_proxy=acc, score=score)


def default_grid(widths: Sequence[int] = DEFAULT_WIDTHS,
                 backends: Sequence[str] = ("torch",),
                 quant: Sequence[Optional[int]] = (None,),
                 include_full: bool = True) -> list[CandidateConfig]:
    """The tuner's candidate grid: strategies x W x backend x quant."""
    grid = [CandidateConfig(s, w, b, q)
            for s, w, b, q in itertools.product(
                ("aes", "afs", "sfs"), widths, backends, quant)]
    if include_full:
        grid += [CandidateConfig("full", 0, b, q)
                 for b, q in itertools.product(backends, quant)]
    return grid


def rank(feats: GraphFeatures, candidates: Iterable[CandidateConfig],
         machine: MachineModel | None = None,
         accuracy_weight: float = 5.0) -> list[CostEstimate]:
    """All candidates, best (lowest score) first.

    With ``machine=None`` each candidate is priced by its *backend's*
    host-calibrated model when enough (predicted, measured) pairs have
    been logged (``repro_torch.tuning.calibration``, per-(host, backend)
    constants — the CUDA kernels and the eager rowloops do not share a
    roofline), falling back to the host-wide fit for thin backend
    slices and to the generic defaults with no log at all."""
    if machine is None:
        from repro_torch.tuning.calibration import calibrated_machine_model

        models: dict = {}

        def model_for(backend: str) -> MachineModel | None:
            if backend not in models:
                models[backend] = calibrated_machine_model(backend=backend)
            return models[backend]

        ests = [predict(feats, c, model_for(c.backend), accuracy_weight)
                for c in candidates]
    else:
        ests = [predict(feats, c, machine, accuracy_weight)
                for c in candidates]
    return sorted(ests, key=lambda e: e.score)
