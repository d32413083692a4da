"""Cost-model calibration: fit ``MachineModel`` constants per host from
logged (predicted, measured) pairs.

The analytic model (``cost_model.py``) ships napkin constants; its job is
ranking, and measurement (``measure.py``) papers over the gap by timing the
analytic top-k on the live backend.  That measurement budget is the cost
this module shrinks: every ``measure_config`` / ``measure_blocked_buckets``
call appends one JSONL record — the machine-independent
:class:`~repro_torch.tuning.cost_model.RooflineTerms` of the measured
config, the model's prediction, the measured microseconds, and a host
fingerprint naming torch's device — into
``$REPRO_PLAN_CACHE_DIR/repro_torch/calibration/`` (beside the port's plan
entries; the cache's disk GC never touches it, and the reference package's
log, one level up, is never read).  Once enough records exist for the
current host, :func:`fit_machine_model` least-squares the roofline
constants (peak FLOP/s, HBM bandwidth, per-launch overhead, per-slot
sampling costs per strategy) with robust outlier rejection, and
``rank()`` / ``tune()`` / ``tune_blocked()`` pick the fitted model up
automatically via :func:`calibrated_machine_model`.  When the fitted
model's recent rank correlation on the logged pairs is high, ``tune()``
shrinks its measurement budget (:func:`effective_budget`) — the model has
earned the right to be trusted further down its ranking.

The fit itself: the roofline ``us = 1e6 * max(A*flops, B*bytes) + C``
(A = 1/peak_flops, B = 1/hbm_bw, C = launch overhead) is piecewise linear,
so the solver alternates regime assignment (compute- vs memory-bound under
the current constants) with a linear least-squares solve per assignment —
from two starts (the prior constants and a data-scaled init), keeping the
lower-residual solution — and rejects outliers beyond 3.5 robust sigmas
(MAD) between rounds.  Constants that a degenerate log cannot identify
(a regime with < 2 records, a non-positive solve) keep the prior's value,
so fitted models are always strictly positive.

CLI::

    python -m repro_torch.tuning.calibration --smoke [--device cpu]
    python -m repro_torch.tuning.calibration fit|show|clear|compact \
        --cache-dir DIR [--device cpu]

``--smoke`` fits synthetic records and asserts the fit ranks better than
the default constants; the commands act on this host's log under ``DIR``
(or ``$REPRO_PLAN_CACHE_DIR``).  ``--device`` (default ``cuda``) names the
device whose host log is meant: the host fingerprint names the card, so
asking for the card without one raises.
"""
from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from repro_torch.tuning.cost_model import (CandidateConfig, MachineModel,
                                           RooflineTerms, terms_latency_us,
                                           terms_sample_us)
from repro_torch.tuning.plan_cache import PLAN_SUBDIR

_ENV_CACHE_DIR = "REPRO_PLAN_CACHE_DIR"
_ENV_CALIBRATION = "REPRO_CALIBRATION"   # "0" disables logging and fitting
_ENV_MAX_RECORDS = "REPRO_CALIBRATION_MAX_RECORDS"  # decay bound; <=0 = off

#: Subdirectory of the port's plan-entry dir holding the per-host JSONL
#: logs.  Lives *beside* the ``*.npz`` plan entries, so the plan cache's
#: disk GC (``$REPRO_PLAN_CACHE_DISK_MAX``) and ``clear(disk=True)`` —
#: both of which glob only ``*.npz`` files — never collect it.
CALIBRATION_DIRNAME = "calibration"

#: Log-record layout version; readers skip records stamped differently.
RECORD_VERSION = 1

#: Calibrated model kicks in once this many latency records exist per host.
MIN_FIT_RECORDS = 24

#: ``tune()`` shrinks its measurement budget when the calibrated model's
#: Spearman rank correlation over the recent logged pairs reaches this.
SHRINK_RANK_CORR = 0.85
SHRINK_WINDOW = 64

#: Record kinds carrying a steady-state latency pair (the roofline fit);
#: "sample" records carry the one-time sampling pre-pass instead.
LATENCY_KINDS = ("spmm", "bucket", "plan")

#: Decay bound: appends keep at most this many records per host (newest
#: win), overridable via ``$REPRO_CALIBRATION_MAX_RECORDS`` (<= 0 turns
#: the automatic decay off).  The fitter's recency windows are far
#: smaller, so 4096 records is months of headroom — the bound exists so
#: the JSONL never grows without limit on a long-lived serving host.
DEFAULT_MAX_RECORDS = 4096

#: Appends between automatic decay checks (per process, per log path):
#: counting the log's lines is O(file), so it is amortized rather than
#: paid on every append.
DECAY_CHECK_EVERY = 64


def max_records_default() -> int:
    """The per-host record bound: ``$REPRO_CALIBRATION_MAX_RECORDS`` when
    set (non-positive disables decay), else :data:`DEFAULT_MAX_RECORDS`."""
    raw = os.environ.get(_ENV_MAX_RECORDS)
    if raw is None or raw == "":
        return DEFAULT_MAX_RECORDS
    try:
        return int(raw)
    except ValueError:
        return DEFAULT_MAX_RECORDS


# ---------------------------------------------------------------------------
# host identity
# ---------------------------------------------------------------------------

_HOST_FP: str | None = None


def host_fingerprint() -> str:
    """Stable hash of what the roofline constants depend on: machine, core
    count, and torch's device (``torch.cuda.get_device_name()``, or
    ``"cpu"`` without a card).  Records from another host never contaminate
    this host's fit."""
    global _HOST_FP
    if _HOST_FP is not None:
        return _HOST_FP
    import platform

    import torch

    parts = [platform.system(), platform.machine(),
             platform.processor() or "", str(os.cpu_count() or 0), "torch",
             torch.cuda.get_device_name() if torch.cuda.is_available()
             else "cpu"]
    _HOST_FP = hashlib.blake2b("|".join(parts).encode(),
                               digest_size=8).hexdigest()
    return _HOST_FP


# ---------------------------------------------------------------------------
# the JSONL log
# ---------------------------------------------------------------------------

def calibration_dir(cache_dir) -> Path:
    """The port's calibration root under a plan-cache directory."""
    return Path(cache_dir) / PLAN_SUBDIR / CALIBRATION_DIRNAME


def measurement_record(kind: str, config: dict, terms: RooflineTerms,
                       predicted_us: float, measured_us: float,
                       graph: Optional[dict] = None,
                       host: Optional[str] = None) -> dict:
    """One log line: everything the fitter and the budget check need."""
    return {
        "v": RECORD_VERSION,
        "host": host or host_fingerprint(),
        "kind": kind,                      # spmm | sample | bucket | plan
        "config": dict(config),
        "graph": dict(graph or {}),
        "terms": terms.to_dict(),
        "predicted_us": float(predicted_us),
        "measured_us": float(measured_us),
    }


class CalibrationLog:
    """Append-only per-host JSONL store under one calibration root.

    Appends are a single ``write()`` on an ``O_APPEND`` descriptor — one
    line per syscall — so concurrent tuners on the same host never
    interleave half-written records; readers additionally skip any line
    that fails to parse (a torn write from a crashed process loses that
    record, nothing else).

    Hygiene: every :data:`DECAY_CHECK_EVERY` appends (per process, per
    file) the log's record count is checked, and a file holding more than
    2x :func:`max_records_default` records is compacted down to the
    newest bound — so a long-lived serving host's log stays
    O(:data:`DEFAULT_MAX_RECORDS`) instead of growing one line per
    measurement forever.  :meth:`compact` is the explicit form (also the
    CLI's ``compact`` command).
    """

    def __init__(self, root):
        self.root = Path(root)
        self._appends: dict[str, int] = {}   # per-path, this process

    def path_for(self, host: Optional[str] = None) -> Path:
        return self.root / f"{host or host_fingerprint()}.jsonl"

    def append(self, record: dict) -> None:
        self.root.mkdir(parents=True, exist_ok=True)
        path = self.path_for(record.get("host"))
        line = json.dumps(record, separators=(",", ":")) + "\n"
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        try:
            os.write(fd, line.encode())
        finally:
            os.close(fd)
        self._maybe_decay(path)

    def _maybe_decay(self, path: Path) -> None:
        """Amortized automatic decay: every :data:`DECAY_CHECK_EVERY`
        appends, compact the file if it holds > 2x the record bound."""
        key = str(path)
        n = self._appends.get(key, 0) + 1
        self._appends[key] = n
        if n % DECAY_CHECK_EVERY:
            return
        max_records = max_records_default()
        if max_records <= 0:
            return
        try:
            with open(path, "rb") as f:
                lines = sum(1 for _ in f)
        except OSError:
            return
        if lines > 2 * max_records:
            self._compact_file(path, max_records)

    @staticmethod
    def _compact_file(path: Path, max_records: int) -> dict:
        """Rewrite one log file keeping only the newest ``max_records``
        parseable record lines (torn/garbage lines are dropped).  The
        rewrite is atomic (`os.replace`); a concurrent appender racing the
        replace can lose at most its own in-flight line — the same
        torn-tail risk readers already tolerate."""
        try:
            raw = path.read_text()
        except OSError:
            return {"kept": 0, "dropped": 0}
        valid = []
        for line in raw.splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                valid.append(line)
        kept = valid[-max_records:] if max_records > 0 else []
        total_lines = len(raw.splitlines())
        tmp = path.with_suffix(".jsonl.tmp")
        tmp.write_text("".join(l + "\n" for l in kept))
        os.replace(tmp, path)
        return {"kept": len(kept), "dropped": total_lines - len(kept)}

    def compact(self, max_records: Optional[int] = None,
                host: Optional[str] = None) -> dict:
        """Shrink log files to the newest ``max_records`` records each.

        ``host=None`` compacts every host's file under this root;
        ``max_records`` defaults to :func:`max_records_default`.  Returns
        ``{"files": n, "kept": total, "dropped": total}``.
        """
        if max_records is None:
            max_records = max_records_default()
        if max_records <= 0:
            raise ValueError(
                f"max_records must be > 0 to compact, got {max_records}")
        paths = [self.path_for(host)] if host is not None else (
            sorted(self.root.glob("*.jsonl")) if self.root.exists() else [])
        out = {"files": 0, "kept": 0, "dropped": 0}
        for p in paths:
            if not p.exists():
                continue
            r = self._compact_file(p, max_records)
            out["files"] += 1
            out["kept"] += r["kept"]
            out["dropped"] += r["dropped"]
        return out

    def records(self, host: Optional[str] = None) -> list[dict]:
        """All valid records for ``host`` (default: this host), in append
        order.  Unparseable or differently-versioned lines are skipped."""
        try:
            data = self.path_for(host).read_text()
        except OSError:
            return []
        out = []
        for line in data.splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict) and rec.get("v") == RECORD_VERSION:
                out.append(rec)
        return out

    def latency_records(self, host: Optional[str] = None) -> list[dict]:
        return [r for r in self.records(host) if r.get("kind")
                in LATENCY_KINDS]

    def clear(self, host: Optional[str] = None) -> int:
        """Drop ``host``'s file (or every host's when None); returns the
        number of files removed."""
        paths = [self.path_for(host)] if host is not None else (
            list(self.root.glob("*.jsonl")) if self.root.exists() else [])
        n = 0
        for p in paths:
            try:
                p.unlink()
                n += 1
            except OSError:
                pass
        return n


# -- process-default log ----------------------------------------------------

_UNSET = object()
_default_log = _UNSET


def default_log() -> Optional[CalibrationLog]:
    """The process-wide log measurement sites append to: an explicit
    :func:`set_default_log` override, else
    ``$REPRO_PLAN_CACHE_DIR/repro_torch/calibration`` when the env var is
    set — unless
    ``$REPRO_CALIBRATION=0`` turns calibration off entirely."""
    if os.environ.get(_ENV_CALIBRATION, "") == "0":
        return None
    if _default_log is not _UNSET:
        return _default_log
    root = os.environ.get(_ENV_CACHE_DIR)
    return CalibrationLog(calibration_dir(root)) if root else None


def set_default_log(log: Optional[CalibrationLog]) -> None:
    """Override the process default (``None`` disables logging even when
    ``$REPRO_PLAN_CACHE_DIR`` is set)."""
    global _default_log
    _default_log = log


def reset_default_log() -> None:
    """Back to env-derived resolution."""
    global _default_log
    _default_log = _UNSET


def log_measurement(kind: str, config: dict, terms: RooflineTerms,
                    predicted_us: float, measured_us: float,
                    graph: Optional[dict] = None) -> None:
    """Append one record to the default log; a no-op without one.  Never
    raises — a full disk must not fail the tuning call it rides on."""
    log = default_log()
    if log is None:
        return
    try:
        log.append(measurement_record(kind, config, terms,
                                      predicted_us, measured_us, graph))
    except Exception:
        pass


# ---------------------------------------------------------------------------
# the fitter
# ---------------------------------------------------------------------------

def spearman(xs: Sequence[float], ys: Sequence[float]) -> float:
    """Spearman rank correlation with tie-averaged ranks; 0.0 when either
    side is constant or fewer than two pairs exist."""
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    if len(xs) < 2 or len(xs) != len(ys):
        return 0.0

    def ranks(a: np.ndarray) -> np.ndarray:
        order = np.argsort(a, kind="mergesort")
        r = np.empty(len(a), np.float64)
        i = 0
        sa = a[order]
        while i < len(a):
            j = i
            while j + 1 < len(a) and sa[j + 1] == sa[i]:
                j += 1
            r[order[i:j + 1]] = 0.5 * (i + j)
            i = j + 1
        return r

    rx, ry = ranks(xs), ranks(ys)
    if rx.std() == 0.0 or ry.std() == 0.0:
        return 0.0
    return float(np.corrcoef(rx, ry)[0, 1])


def _solve_roofline(flops: np.ndarray, byts: np.ndarray, y: np.ndarray,
                    a0: float, b0: float, c0: float,
                    max_rounds: int = 8) -> tuple[float, float, float, float]:
    """Alternate regime assignment with a masked linear solve from one
    start; returns (A, B, C, masked residual sum of squares).  Constants a
    regime cannot identify (< 2 records, non-positive solve) keep the
    start's value; C is clamped strictly positive."""
    n = len(y)
    a, b, c = a0, b0, c0
    mask = np.ones(n, bool)
    for _ in range(max_rounds):
        compute = flops * a >= byts * b
        x = np.zeros((n, 3))
        x[compute, 0] = 1e6 * flops[compute]
        x[~compute, 1] = 1e6 * byts[~compute]
        x[:, 2] = 1.0
        # Column equilibration: the flops/bytes columns are ~1e12x the
        # intercept column, and lstsq's rank cutoff would silently drop
        # the overhead term from such a system.
        col = np.linalg.norm(x[mask], axis=0)
        col[col == 0] = 1.0
        sol, *_ = np.linalg.lstsq(x[mask] / col, y[mask], rcond=None)
        sol = sol / col
        na = float(sol[0]) if compute[mask].sum() >= 2 and sol[0] > 0 else a
        nb = float(sol[1]) if (~compute)[mask].sum() >= 2 and sol[1] > 0 else b
        nc = max(float(sol[2]), 1e-3)
        resid = y - x @ np.array([na, nb, nc])
        med = float(np.median(resid[mask]))
        mad = float(np.median(np.abs(resid[mask] - med)))
        if mad > 0:
            new_mask = np.abs(resid - med) <= 3.5 * 1.4826 * mad
            if new_mask.sum() >= max(3, n // 2):
                mask = new_mask
        done = (abs(na - a) <= 1e-9 * abs(a) and abs(nb - b) <= 1e-9 * abs(b)
                and abs(nc - c) <= 1e-9 * max(abs(c), 1.0))
        a, b, c = na, nb, nc
        if done:
            break
    compute = flops * a >= byts * b
    pred = 1e6 * np.where(compute, flops * a, byts * b) + c
    sse = float(((y - pred)[mask] ** 2).sum())
    return a, b, c, sse


def fit_machine_model(records: Sequence[dict],
                      base: MachineModel | None = None,
                      backend: str | None = None) -> MachineModel:
    """Least-squares the roofline constants from logged records.

    Latency records (kinds ``spmm``/``bucket``/``plan``) fit
    (peak_flops, hbm_bw, launch_overhead_us); ``sample`` records fit the
    per-slot ``sample_cost_ns`` per strategy (robust median of the
    per-record implied slope, reusing the fitted overhead).  Terms a
    degenerate log cannot identify keep ``base``'s values, so the result
    is always strictly positive.

    ``backend`` restricts the fit to records whose config ran on that
    execution backend — the CUDA kernels and the eager rowloops have
    wildly different effective constants on the same host, so one blended
    fit misprices whichever backend has fewer records.  When the
    filtered set is too thin to fit (< 3 latency records) the full set is
    used instead — a coarse fit beats the napkin constants.
    """
    base = base or MachineModel()
    if backend is not None:
        sel = [r for r in records
               if r.get("config", {}).get("backend") == backend]
        if sum(1 for r in sel if r.get("kind") in LATENCY_KINDS) >= 3:
            records = sel
    a, b, c = 1.0 / base.peak_flops, 1.0 / base.hbm_bw, \
        base.launch_overhead_us

    lat = [r for r in records if r.get("kind") in LATENCY_KINDS]
    triples = []
    for r in lat:
        try:
            t = RooflineTerms.from_dict(r["terms"])
            m = float(r["measured_us"])
        except (KeyError, TypeError, ValueError):
            continue
        if np.isfinite(m) and m > 0 and t.flops >= 0 and t.bytes >= 0:
            triples.append((t.flops, t.bytes, m))
    if len(triples) >= 3:
        flops = np.asarray([t[0] for t in triples])
        byts = np.asarray([t[1] for t in triples])
        y = np.asarray([t[2] for t in triples])
        starts = [(a, b, c)]
        with np.errstate(divide="ignore", invalid="ignore"):
            da = float(np.median(y / np.maximum(1e6 * flops, 1e-30)))
            db = float(np.median(y / np.maximum(1e6 * byts, 1e-30)))
        if np.isfinite(da) and da > 0 and np.isfinite(db) and db > 0:
            starts.append((da, db, max(float(y.min()) * 0.5, 1e-3)))
        fits = [_solve_roofline(flops, byts, y, *s) for s in starts]
        a, b, c, _ = min(fits, key=lambda f: f[3])

    costs = dict(base.sample_cost_ns)
    by_strategy: dict[str, list[tuple[float, float]]] = {}
    for r in records:
        if r.get("kind") != "sample":
            continue
        try:
            strat = str(r["config"]["strategy"])
            slots = float(r["terms"]["slots"])
            m = float(r["measured_us"])
        except (KeyError, TypeError, ValueError):
            continue
        if np.isfinite(m) and m > 0 and slots > 0:
            by_strategy.setdefault(strat, []).append((slots, m))
    for strat, pairs in by_strategy.items():
        if len(pairs) < 2:
            continue
        est = np.asarray([(m - c) * 1e3 / slots for slots, m in pairs])
        med = float(np.median(est))
        if np.isfinite(med) and med > 0:
            costs[strat] = med

    return MachineModel(peak_flops=1.0 / a, hbm_bw=1.0 / b,
                        launch_overhead_us=c, sample_cost_ns=costs)


# ---------------------------------------------------------------------------
# loader + budget policy (what rank()/tune() consume)
# ---------------------------------------------------------------------------

_FIT_CACHE: dict[tuple, Optional[MachineModel]] = {}


def calibrated_machine_model(log: Optional[CalibrationLog] = None,
                             host: Optional[str] = None,
                             min_records: int | None = None,
                             backend: Optional[str] = None,
                             ) -> Optional[MachineModel]:
    """The host-fitted model, or ``None`` when calibration is off, no log
    is configured, or fewer than ``min_records`` latency records exist.
    Fits are memoized on the log file's (size, mtime), so ranking a
    thousand blocks refits at most once per appended batch.

    ``backend`` selects the per-(host, backend) constants: when that
    backend has accumulated ``min_records`` of its own latency records
    the fit uses only them; below that it falls back to the host's
    all-backend fit (which must itself clear ``min_records``)."""
    log = log if log is not None else default_log()
    if log is None:
        return None
    host = host or host_fingerprint()
    min_records = MIN_FIT_RECORDS if min_records is None else min_records
    path = log.path_for(host)
    try:
        st = path.stat()
    except OSError:
        return None
    key = (str(path), st.st_size, st.st_mtime_ns, min_records, backend)
    if key in _FIT_CACHE:
        return _FIT_CACHE[key]
    records = log.records(host)
    n_lat = sum(1 for r in records if r.get("kind") in LATENCY_KINDS)
    if n_lat < min_records:
        model = None
    else:
        fit_backend = backend
        if backend is not None:
            n_b = sum(1 for r in records if r.get("kind") in LATENCY_KINDS
                      and r.get("config", {}).get("backend") == backend)
            if n_b < min_records:
                fit_backend = None    # thin backend slice: host-wide fit
        model = fit_machine_model(records, backend=fit_backend)
    if len(_FIT_CACHE) > 64:
        _FIT_CACHE.clear()
    _FIT_CACHE[key] = model
    return model


def _latency_stats(log: CalibrationLog, host: Optional[str],
                   window: int) -> tuple[int, list[RooflineTerms],
                                         list[float]]:
    """(total latency-record count, recent-window terms, recent-window
    measurements) — memoized on the log file's (size, mtime) beside the
    fit cache, so a warm ``tune()`` does not re-parse the whole
    append-only log twice per call."""
    host = host or host_fingerprint()
    path = log.path_for(host)
    try:
        st = path.stat()
    except OSError:
        return 0, [], []
    key = ("stats", str(path), st.st_size, st.st_mtime_ns, window)
    if key in _FIT_CACHE:
        return _FIT_CACHE[key]
    lat = log.latency_records(host)
    terms, meas = [], []
    for r in lat[-window:]:
        try:
            t = RooflineTerms.from_dict(r["terms"])
            m = float(r["measured_us"])
        except (KeyError, TypeError, ValueError):
            continue
        terms.append(t)
        meas.append(m)
    if len(_FIT_CACHE) > 64:
        _FIT_CACHE.clear()
    _FIT_CACHE[key] = (len(lat), terms, meas)
    return _FIT_CACHE[key]


def rank_correlation(machine: MachineModel,
                     log: Optional[CalibrationLog] = None,
                     host: Optional[str] = None,
                     window: int = SHRINK_WINDOW) -> float:
    """Spearman rank correlation of ``machine``'s predictions against the
    most recent ``window`` logged latency measurements."""
    log = log if log is not None else default_log()
    if log is None:
        return 0.0
    _, terms, meas = _latency_stats(log, host, window)
    if len(meas) < 2:
        return 0.0
    return spearman([terms_latency_us(t, machine) for t in terms], meas)


def effective_budget(budget: int, *,
                     machine: Optional[MachineModel] = None,
                     log: Optional[CalibrationLog] = None,
                     host: Optional[str] = None,
                     threshold: float = SHRINK_RANK_CORR,
                     min_keep: int = 2) -> int:
    """Shrink ``tune()``'s measurement budget when the calibrated model has
    earned it: with >= :data:`MIN_FIT_RECORDS` logged pairs and recent rank
    correlation >= ``threshold``, measuring the full analytic top-k buys
    little — the top of the ranking is already trustworthy — so only
    ``max(min_keep, budget // 3)`` candidates are timed."""
    if budget <= min_keep:
        return budget
    log = log if log is not None else default_log()
    if log is None:
        return budget
    machine = machine if machine is not None \
        else calibrated_machine_model(log=log, host=host)
    if machine is None:
        return budget
    n_latency, _, _ = _latency_stats(log, host, SHRINK_WINDOW)
    if n_latency < MIN_FIT_RECORDS:
        return budget
    if rank_correlation(machine, log=log, host=host) >= threshold:
        return max(min_keep, budget // 3)
    return budget


# ---------------------------------------------------------------------------
# CLI: python -m repro_torch.tuning.calibration fit|show|clear|compact
#      [--smoke]
# ---------------------------------------------------------------------------

def synthetic_records(num: int = 30, seed: int = 0,
                      true_model: MachineModel | None = None,
                      host: str = "smoke-host") -> list[dict]:
    """Records "measured" by a known machine over a mixed compute-/memory-
    bound config spread — the smoke fits these and must improve on the
    default constants.  The true machine inverts the default's
    compute/memory balance so the default *misorders* the grid.  The draws
    are the reference package's, record for record."""
    rng = np.random.default_rng(seed)
    true_model = true_model or MachineModel(
        peak_flops=MachineModel().peak_flops / 16.0,
        hbm_bw=MachineModel().hbm_bw * 4.0,
        launch_overhead_us=240.0,
        sample_cost_ns={"sfs": 2.0, "afs": 6.0, "aes": 4.0, "full": 1.0})
    default = MachineModel()
    out = []
    strategies = ("aes", "afs", "sfs", "full")
    for i in range(num):
        scale = float(10.0 ** rng.uniform(6.5, 9.0))
        ratio = float(10.0 ** rng.uniform(-1.5, 1.5))   # flops : bytes
        terms = RooflineTerms(flops=scale * ratio, bytes=scale,
                              slots=scale / 64.0)
        strat = strategies[i % len(strategies)]
        cfg = CandidateConfig(strat, 0 if strat == "full" else 64)
        true_us = terms_latency_us(terms, true_model)
        jitter = 1.0 + 0.02 * float(rng.standard_normal())
        out.append(measurement_record(
            "spmm", cfg.to_dict(), terms,
            predicted_us=terms_latency_us(terms, default),
            measured_us=true_us * jitter, host=host))
        out.append(measurement_record(
            "sample", cfg.to_dict(), terms,
            predicted_us=terms_sample_us(terms, strat, default),
            measured_us=terms_sample_us(terms, strat, true_model) * jitter,
            host=host))
    return out


def _smoke(as_json: bool) -> dict:
    records = synthetic_records(30)
    lat = [r for r in records if r["kind"] in LATENCY_KINDS]
    meas = [r["measured_us"] for r in lat]
    terms = [RooflineTerms.from_dict(r["terms"]) for r in lat]
    base_rho = spearman([r["predicted_us"] for r in lat], meas)
    fitted = fit_machine_model(records)
    fit_rho = spearman([terms_latency_us(t, fitted) for t in terms], meas)
    report = {
        "records": len(lat),
        "rank_corr_default": round(base_rho, 4),
        "rank_corr_fitted": round(fit_rho, 4),
        "fitted": {k: round(v, 4) if isinstance(v, float) else v
                   for k, v in fitted.to_dict().items()
                   if k != "sample_cost_ns"},
    }
    print(json.dumps(report, indent=None if as_json else 2))
    if fit_rho <= base_rho:
        raise AssertionError(f"fitted rank correlation {fit_rho:.3f} <= "
                             f"default {base_rho:.3f}")
    for name, v in (("peak_flops", fitted.peak_flops),
                    ("hbm_bw", fitted.hbm_bw),
                    ("launch_overhead_us", fitted.launch_overhead_us),
                    *fitted.sample_cost_ns.items()):
        if not v > 0:
            raise AssertionError(f"non-positive fitted constant {name}={v}")
    print("smoke: OK")
    return report


def _resolve_cli_log(cache_dir: str | None) -> CalibrationLog:
    root = cache_dir or os.environ.get(_ENV_CACHE_DIR)
    if not root:
        raise SystemExit("no calibration log: pass --cache-dir or set "
                         f"${_ENV_CACHE_DIR}")
    return CalibrationLog(calibration_dir(root))


def main(argv: Sequence[str] | None = None) -> None:
    import argparse

    from repro_torch._device import resolve_device

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.tuning.calibration",
        description="Inspect / fit / clear the per-host cost-model "
                    "calibration log.")
    p.add_argument("command", nargs="?",
                   choices=("fit", "show", "clear", "compact"),
                   help="what to do with the log (omit with --smoke)")
    p.add_argument("--cache-dir", default=None,
                   help="plan-cache dir holding the port's calibration/ "
                        f"(default: ${_ENV_CACHE_DIR})")
    p.add_argument("--host", default=None,
                   help="host fingerprint to operate on (default: this "
                        "host; 'all' clears/compacts every host)")
    p.add_argument("--min-records", type=int, default=MIN_FIT_RECORDS)
    p.add_argument("--max-records", type=int, default=None,
                   help="records kept per host by 'compact' (default: "
                        f"${_ENV_MAX_RECORDS} or {DEFAULT_MAX_RECORDS})")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu: the device whose host log "
                        "is meant")
    p.add_argument("--smoke", action="store_true",
                   help="fit 30 synthetic records and assert the rank "
                        "correlation improves (CI gate; needs no log)")
    p.add_argument("--json", action="store_true",
                   help="single-line JSON output")
    args = p.parse_args(argv)
    resolve_device(args.device)

    if args.smoke:
        _smoke(args.json)
        return
    if not args.command:
        p.error("need a command (fit | show | clear | compact) or --smoke")

    log = _resolve_cli_log(args.cache_dir)
    if args.command == "clear":
        n = log.clear(None if args.host == "all"
                      else args.host or host_fingerprint())
        print(json.dumps({"cleared_files": n}))
        return
    if args.command == "compact":
        r = log.compact(max_records=args.max_records,
                        host=None if args.host == "all"
                        else args.host or host_fingerprint())
        print(json.dumps(r))
        return

    host = args.host or host_fingerprint()
    records = log.records(host)
    lat = [r for r in records if r.get("kind") in LATENCY_KINDS]
    report: dict = {"host": host, "path": str(log.path_for(host)),
                    "records": len(records), "latency_records": len(lat)}
    if args.command == "show":
        report["min_records"] = args.min_records
        report["active"] = len(lat) >= args.min_records
        if lat:
            report["rank_corr_logged"] = round(spearman(
                [r["predicted_us"] for r in lat],
                [r["measured_us"] for r in lat]), 4)
    want_fit = args.command == "fit" or report.get("active")
    if args.command == "fit" and len(lat) < 3:
        raise SystemExit(f"only {len(lat)} latency records for host {host} "
                         "(need >= 3 to fit)")
    if want_fit and len(lat) >= 3:
        fitted = fit_machine_model(records)
        report["fitted"] = fitted.to_dict()
        report["rank_corr_fitted"] = round(
            rank_correlation(fitted, log=log, host=host), 4)
    print(json.dumps(report, indent=None if args.json else 2))


if __name__ == "__main__":
    main()
