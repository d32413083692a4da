"""Plan cache: graph fingerprint -> TunedPlan (config + prepared operand).

A ``TunedPlan`` carries everything a repeated inference needs so that serving
never re-samples or re-quantizes: the chosen ``CandidateConfig``, the sampled
``ELL`` operand, and (when the config quantizes) the pre-quantized feature
matrix.  ES-SpMM's cache-first design is the motivation — tune once per
graph, then serve every request from the cached plan.

Two kinds of plan share the cache:

  * ``TunedPlan`` — one global (strategy, W, backend, quant) for the whole
    graph, with its sampled ``ELL`` operand;
  * ``BlockedPlan`` — per-row-block (strategy, W) stitched into a
    mixed-width ``BlockELL`` operand (``granularity="block"``), plus the
    tuned width-bucket table and (optionally) the pre-quantized feature
    matrix served through the fused-dequant gather.  The fingerprint
    semantics are unchanged (content hash of the CSR); the two kinds are
    stored side by side under ``(fingerprint, kind)``.

Either kind may additionally be a *per-shard* plan (the serving slice): the
key is then ``(fingerprint, kind, shard_meta)`` where ``shard_meta =
(mesh_shape, shard_idx, num_shards)`` — a shard's plan never collides with
the whole-graph plan of the same CSR content, and a mesh reshape retunes
rather than serving stale shard layouts.

Two tiers:

  * in-memory LRU — always on; hit == dict lookup; bounded to
    ``$REPRO_PLAN_CACHE_MAX`` plans (default 64), least-recently-used
    evicted first;
  * on-disk directory (``cache_dir`` or ``$REPRO_PLAN_CACHE_DIR``) — one
    ``repro_torch/<fingerprint>.npz`` (global) /
    ``repro_torch/<fingerprint>.block.npz`` (blocked) per plan (arrays +
    JSON-encoded config), surviving process restarts.  The port's entries
    live in their own ``repro_torch/`` subdirectory and carry their own
    schema stamp (:data:`PLAN_SCHEMA_VERSION`), so a directory shared with
    the reference package keeps the two apart: neither package loads,
    counts or collects the other's entries.  Disk is only consulted on a
    memory miss and re-warms the memory tier.
    Bounded by ``$REPRO_PLAN_CACHE_DISK_MAX`` entries (0/unset =
    unbounded): each save garbage-collects the least-recently-used files
    by mtime, and disk hits refresh mtime so recency tracks use.

Every on-disk entry is stamped with :data:`PLAN_SCHEMA_VERSION`; entries
stamped otherwise (the reference package's integer
``PLAN_SCHEMA_VERSION``, or no stamp at all) are *rejected on load* and treated as a miss — the tuner
rewrites them — rather than risk mis-reading another layout.

The cost-model calibration log (``repro_torch.tuning.calibration``) lives
in a ``calibration/`` subdirectory *beside* the entry files.  Both the disk GC
and ``clear(disk=True)`` operate on top-level ``*.npz`` entry files only,
so evicting or clearing plans never discards the host's accumulated
(predicted, measured) history — plans are rebuildable, calibration data is
not.

The module-level ``default_cache()`` (memory-only unless the env var is set)
backs ``aes_spmm(..., strategy="auto")``.  Plans loaded from disk land on
the device the caller asks for (``get(..., device=)``; the tuner passes the
CSR's).
"""
from __future__ import annotations

import json
import os
import zipfile
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.core.graph import ELL, BlockELL, _np
from repro_torch.core.quantization import QuantizedFeatures
from repro_torch.tuning.cost_model import CandidateConfig

_ENV_DIR = "REPRO_PLAN_CACHE_DIR"
_ENV_MAX = "REPRO_PLAN_CACHE_MAX"
_ENV_DISK_MAX = "REPRO_PLAN_CACHE_DISK_MAX"

#: Subdirectory of the cache directory holding the port's entries (the
#: reference package's ``*.npz`` sit at its top level).
PLAN_SUBDIR = "repro_torch"

#: On-disk entry layout stamp: the reference package's v6 layout (same
#: arrays and meta keys) under the port's own name.  A string, so it never
#: equals the reference's integer ``PLAN_SCHEMA_VERSION``; loaders reject
#: any other stamp (treated as a miss, so the tuner rewrites the entry).
PLAN_SCHEMA_VERSION = "repro_torch/1"

_DEFAULT_MAX_PLANS = 64


def normalize_shard_meta(shard_meta):
    """Canonical ``(mesh_shape, shard_idx, num_shards)`` tuple (or None).

    Accepts lists/np ints from JSON round-trips; validates the index is in
    range and the mesh has capacity for the shard count so a malformed key
    fails at construction, not as a silent cache split.
    """
    if shard_meta is None:
        return None
    mesh_shape, shard_idx, num_shards = shard_meta
    mesh_shape = tuple(int(d) for d in mesh_shape)
    shard_idx, num_shards = int(shard_idx), int(num_shards)
    if num_shards < 1 or not 0 <= shard_idx < num_shards \
            or int(np.prod(mesh_shape or (0,))) < num_shards:
        raise ValueError(f"invalid shard_meta {shard_meta!r}")
    return (mesh_shape, shard_idx, num_shards)


def _shard_tag(shard_meta) -> str:
    """Filesystem-/key-safe encoding of a normalized shard_meta."""
    mesh_shape, shard_idx, num_shards = shard_meta
    return f"m{'x'.join(str(d) for d in mesh_shape)}.s{shard_idx}of{num_shards}"


def features_fingerprint(features) -> str:
    """Content hash of a dense feature matrix (guards cached quantized
    operands).  O(N*F) memory traffic — only paid on quantized plans; on
    the card one device-to-host copy of the matrix.  Hashes the numpy view
    (``str(dtype)`` reads ``float32``), so the same matrix gets the
    reference package's hash."""
    import hashlib

    arr = np.ascontiguousarray(_np(features))
    h = hashlib.blake2b(digest_size=16)
    h.update(str(arr.shape).encode())
    h.update(str(arr.dtype).encode())
    h.update(arr.tobytes())
    return h.hexdigest()


@dataclass
class TunedPlan:
    """Everything needed to serve SpMM requests for one graph."""

    config: CandidateConfig
    ell: ELL
    quantized: Optional[QuantizedFeatures]
    fingerprint: str
    features_fp: str = ""    # content hash of the matrix `quantized` encodes
    predicted_us: float = 0.0
    measured_spmm_us: float = 0.0
    measured_sample_us: float = 0.0
    shard_meta: Optional[tuple] = None  # (mesh_shape, shard_idx, num_shards)

    kind = "global"

    def __post_init__(self):
        # the operand's live widths, once per plan (tuned or loaded from
        # disk, whose file keeps val/col only), so no request decodes them
        self.ell = self.ell._replace(live_w=self.ell.live_widths())

    def run(self, features):
        """Steady-state aggregation: SpMM over the cached operand.

        The pre-quantized matrix follows the paper's *offline* quantization
        semantics: it stands in for the exact node-feature matrix the plan
        was tuned with, verified by content hash — any other dense operand
        (a hidden-layer activation, an updated feature table) falls back to
        the raw float path rather than silently aggregating stale data.

        Dispatch (including the hash guard) lives in
        :class:`repro_torch.exec.PlanExecutor`; this is a thin delegate.
        """
        from repro_torch.exec import default_executor

        return default_executor().run_plan(self, features)


@dataclass
class BlockedPlan:
    """Per-row-block tuned plan: mixed-width BlockELL operand + dispatch.

    The block table (per-block widths, strategies, slot offsets) lives
    inside ``bell``; ``block_configs()`` re-exposes it as (strategy, W)
    pairs for reporting.  ``buckets`` is the tuned width-bucket partition
    (``core.graph.partition_width_buckets`` layout) the cuda backend
    launches — one kernel call per bucket.  ``quantized`` (when set) is the pre-quantized
    feature matrix the plan serves through the fused-dequant gather, guarded
    by ``features_fp`` exactly like :class:`TunedPlan`.

    ``block_digests`` are the fixed-granularity CSR content digests the
    plan's fingerprint combines (``repro_torch.core.graph.csr_block_digests``);
    carrying them in the plan is what lets ``apply_edge_updates`` roll the
    fingerprint forward after an edge delta by re-digesting only touched
    blocks.  ``version`` counts applied patches (0 == cold tune) — the
    atomic tmp+rename disk write makes each patched version a single
    all-or-nothing swap, so a concurrent loader sees version N or N+1,
    never a torn mix.

    ``layout`` is the *requested* row layout the plan was tuned under
    ("natural" | "degree_sorted" | "auto") and is part of the cache key —
    two layouts of the same graph coexist.  ``perm`` (when set) maps
    permuted row position -> natural row id; the BlockELL was stitched over
    the permuted CSR and the executor restores natural order via
    ``inv_perm()`` on the output.  ``perm=None`` means natural order (an
    "auto" tune that picked natural stores no perm).  Fingerprint and
    block digests are always computed over the *natural*-order CSR, so a
    layout change never moves the key's fingerprint component.

    ``quant_drift`` accumulates the worst observed feature-range drift
    (``quantization.range_drift``) across incremental patches; past
    ``quantization.DRIFT_THRESHOLD`` the patch path re-derives the
    quantization range instead of clipping to the stored one.
    """

    bell: BlockELL
    backend: str                    # "torch" (rowloop) | "cuda" (block kernel)
    fingerprint: str
    quantized: Optional[QuantizedFeatures] = None
    features_fp: str = ""           # content hash of the matrix `quantized` encodes
    buckets: tuple = ()             # ((bucket_width, (block ids, ...)), ...)
    predicted_us: float = 0.0       # sum of per-block analytic latencies
    measured_spmm_us: float = 0.0
    measured_bucket_us: tuple = ()  # per-bucket microbench, aligned w/ buckets
    shard_meta: Optional[tuple] = None  # (mesh_shape, shard_idx, num_shards)
    block_digests: tuple = ()       # DIGEST_BLOCK_ROWS-granularity CSR digests
    version: int = 0                # bumped by each apply_edge_updates patch
    layout: str = "natural"         # requested layout (part of the cache key)
    perm: Optional[np.ndarray] = None   # permuted position -> natural row id
    quant_drift: float = 0.0        # worst observed feature-range drift

    kind = "block"

    @property
    def block_rows(self) -> int:
        return self.bell.block_rows

    @property
    def row_layout(self) -> str:
        """The *resolved* layout of the stitched operand ("natural" |
        "degree_sorted") — an ``layout="auto"`` tune that picked natural
        resolves to "natural" here."""
        return "natural" if self.perm is None else "degree_sorted"

    def inv_perm(self):
        """Inverse permutation on the operand's device (natural row ``r``
        lives at permuted position ``inv_perm()[r]``), or None for
        natural-order plans.  Memoized on the instance — ``dataclasses.
        replace`` drops the memo along with the instance."""
        if self.perm is None:
            return None
        cached = getattr(self, "_inv_perm_cache", None)
        if cached is None:
            perm = np.asarray(self.perm, np.int64)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.size, dtype=np.int64)
            cached = torch.from_numpy(inv).to(self.bell.val.device)
            object.__setattr__(self, "_inv_perm_cache", cached)
        return cached

    def block_configs(self) -> list[tuple[str, int]]:
        """Per-block (strategy, width) — the stitched tuning decisions."""
        return list(zip(self.bell.strategies, self.bell.widths))

    def run(self, features, *, assume_tuned: bool = False):
        """Steady-state aggregation: width-bucketed block-dispatched SpMM
        over the cached mixed-width operand.

        Same offline-quantization semantics as :class:`TunedPlan.run`: the
        pre-quantized matrix serves only the exact feature matrix the plan
        was tuned with (content-hash verified); any other dense operand (a
        hidden-layer activation, say) takes the float path.  A
        ``QuantizedFeatures`` operand stands for its Eq. 2 reconstruction
        (the hash a qf-tuned plan stores).

        ``assume_tuned=True`` asserts ``features`` *is* the tuned matrix
        and skips the per-call content hash (a caller that verified the
        match once keeps its hot path free of host-side hashing); a
        quantized plan may then be run with ``features=None`` (the cached
        operand serves).

        Dispatch (guards, bucketed launches, backend matrix) lives in
        :class:`repro_torch.exec.PlanExecutor`; this is a thin delegate.
        """
        from repro_torch.exec import default_executor

        return default_executor().run_plan(self, features,
                                           assume_tuned=assume_tuned)


AnyPlan = Union[TunedPlan, BlockedPlan]


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    disk_hits: int = 0

    @property
    def total(self) -> int:
        return self.hits + self.misses


class PlanCache:
    """Bounded in-memory LRU + optional on-disk (fingerprint, kind) ->
    plan store (disk entries under ``<cache_dir>/repro_torch/``).

    ``max_plans`` bounds the memory tier (the prepared operands are the big
    payload); default from ``$REPRO_PLAN_CACHE_MAX`` (fallback 64).
    ``max_disk_plans`` bounds the disk tier: on every save, entry files
    beyond the bound are garbage-collected least-recently-used first
    (recency = file mtime; disk hits refresh it).  Default from
    ``$REPRO_PLAN_CACHE_DISK_MAX``; 0/unset means unbounded, matching the
    pre-bound behavior.
    """

    def __init__(self, cache_dir: str | os.PathLike | None = None,
                 max_plans: int | None = None,
                 max_disk_plans: int | None = None):
        if cache_dir is None:
            cache_dir = os.environ.get(_ENV_DIR) or None
        #: the shared directory; the port's entries sit in ``entry_dir``
        self.cache_dir = Path(cache_dir) if cache_dir else None
        self.entry_dir = None if self.cache_dir is None \
            else self.cache_dir / PLAN_SUBDIR
        if max_plans is None:
            max_plans = int(os.environ.get(_ENV_MAX) or _DEFAULT_MAX_PLANS)
        self.max_plans = max(int(max_plans), 1)
        if max_disk_plans is None:
            max_disk_plans = int(os.environ.get(_ENV_DISK_MAX) or 0)
        self.max_disk_plans = max(int(max_disk_plans), 0)   # 0 == unbounded
        self._mem: OrderedDict[str, AnyPlan] = OrderedDict()
        self.stats = CacheStats()

    @staticmethod
    def _key(fingerprint: str, kind: str, shard_meta=None,
             layout: str = "natural") -> str:
        shard_meta = normalize_shard_meta(shard_meta)
        tag = "" if shard_meta is None else f"|{_shard_tag(shard_meta)}"
        # natural keeps the legacy key format so existing entries and every
        # pre-layout call site key identically; other layouts get their own
        # namespace (two layouts of one graph coexist side by side)
        ly = "" if layout == "natural" else f"|ly:{layout}"
        return f"{fingerprint}|{kind}{tag}{ly}"

    def _insert(self, key: str, plan: AnyPlan) -> None:
        self._mem[key] = plan
        self._mem.move_to_end(key)
        while len(self._mem) > self.max_plans:
            self._mem.popitem(last=False)   # least recently used

    # -- lookup ----------------------------------------------------------

    def get(self, fingerprint: str, kind: str = "global",
            shard_meta=None, layout: str = "natural",
            device=None) -> Optional[AnyPlan]:
        """Fetch the ``kind`` ("global" | "block") plan for a fingerprint;
        None on a miss.  ``shard_meta`` selects a per-shard serving plan
        (``(mesh_shape, shard_idx, num_shards)``); None means the
        whole-graph plan.  ``layout`` selects the row layout the plan was
        *requested* under ("natural" | "degree_sorted" | "auto" — blocked
        plans only).  Hits refresh LRU recency.  A plan read from disk
        lands on ``device`` (default ``"cuda"``)."""
        shard_meta = normalize_shard_meta(shard_meta)
        key = self._key(fingerprint, kind, shard_meta, layout)
        with obs.trace("plan_cache.get", kind=kind) as sp:
            plan = self._mem.get(key)
            if plan is not None:
                self._mem.move_to_end(key)
                self.stats.hits += 1
                obs.count("plan_cache.hit_memory")
                sp.set(tier="memory")
                return plan
            if self.cache_dir is not None:
                plan = self._load_disk(fingerprint, kind, shard_meta, layout,
                                       resolve_device(device))
                if plan is not None:
                    self._insert(key, plan)
                    self.stats.hits += 1
                    self.stats.disk_hits += 1
                    obs.count("plan_cache.hit_disk")
                    sp.set(tier="disk")
                    return plan
            self.stats.misses += 1
            obs.count("plan_cache.miss")
            sp.set(tier="miss")
            return None

    def put(self, plan: AnyPlan) -> None:
        with obs.trace("plan_cache.put", kind=plan.kind,
                       disk=self.cache_dir is not None):
            obs.count("plan_cache.put")
            self._insert(
                self._key(plan.fingerprint, plan.kind, plan.shard_meta,
                          getattr(plan, "layout", "natural")), plan)
            if self.cache_dir is not None:
                self._save_disk(plan)

    def __contains__(self, fingerprint: str) -> bool:
        """True iff ``get()`` would hit for *some* (kind, shard_meta) —
        memory, or a schema-valid disk entry (a stale-schema file is not
        membership).

        A pure probe: reads only each entry's meta header, deserializes no
        arrays, and does *not* refresh disk-LRU recency — polling
        membership never shields an unused entry from
        ``$REPRO_PLAN_CACHE_DISK_MAX`` eviction."""
        prefix = f"{fingerprint}|"
        if any(k.startswith(prefix) for k in self._mem):
            return True
        if self.entry_dir is None or not self.entry_dir.exists():
            return False
        # every entry file of this fingerprint (shard-tagged or not):
        # <fp>[.<shard_tag>][.block].npz — fingerprints are fixed-length
        # hex, so the prefix glob cannot catch another fingerprint
        return any(self._peek_file(p, fingerprint)
                   for p in self.entry_dir.glob(f"{fingerprint}*.npz")
                   if not p.name.endswith(".tmp.npz"))

    def __len__(self) -> int:
        return len(self._mem)

    @property
    def calibration_dir(self) -> Optional[Path]:
        """Where this cache's calibration log lives (None for a memory-only
        cache): a subdirectory beside the plan entries, outside the
        ``*.npz`` globs the disk GC and ``clear(disk=True)`` collect."""
        if self.cache_dir is None:
            return None
        from repro_torch.tuning.calibration import calibration_dir

        return calibration_dir(self.cache_dir)

    def plans(self) -> list[AnyPlan]:
        """In-memory plans (least- to most-recently used)."""
        return list(self._mem.values())

    def clear(self, disk: bool = False) -> None:
        self._mem.clear()
        self.stats = CacheStats()
        if disk and self.entry_dir is not None and self.entry_dir.exists():
            for p in self.entry_dir.glob("*.npz"):
                p.unlink()

    # -- disk tier -------------------------------------------------------

    def _path(self, fingerprint: str, kind: str = "global",
              shard_meta=None, layout: str = "natural") -> Path:
        shard = "" if shard_meta is None else f".{_shard_tag(shard_meta)}"
        # natural keeps the legacy filename; other layouts add a component
        # so both layouts of one graph persist side by side
        ly = "" if layout == "natural" else f".ly-{layout}"
        suffix = ".npz" if kind == "global" else ".block.npz"
        return self.entry_dir / f"{fingerprint}{shard}{ly}{suffix}"

    @staticmethod
    def _shard_meta_json(shard_meta):
        if shard_meta is None:
            return None
        mesh_shape, shard_idx, num_shards = shard_meta
        return [list(mesh_shape), shard_idx, num_shards]

    def _save_disk(self, plan: AnyPlan) -> None:
        self.entry_dir.mkdir(parents=True, exist_ok=True)
        shard_meta = normalize_shard_meta(plan.shard_meta)
        if plan.kind == "block":
            meta = {
                "schema": PLAN_SCHEMA_VERSION,
                "kind": "block",
                "fingerprint": plan.fingerprint,
                "shard_meta": self._shard_meta_json(shard_meta),
                "backend": plan.backend,
                "block_rows": plan.bell.block_rows,
                "num_rows": plan.bell.num_rows,
                "num_cols": plan.bell.num_cols,
                "strategies": list(plan.bell.strategies),
                "buckets": [[int(w), [int(i) for i in ids]]
                            for w, ids in plan.buckets],
                "features_fp": plan.features_fp,
                "quant_bits": None if plan.quantized is None
                else plan.quantized.bits,
                "predicted_us": plan.predicted_us,
                "measured_spmm_us": plan.measured_spmm_us,
                "measured_bucket_us": [float(u)
                                       for u in plan.measured_bucket_us],
                "block_digests": list(plan.block_digests),
                "version": int(plan.version),
                "layout": plan.layout,
                "quant_drift": float(plan.quant_drift),
            }
            arrays = {
                "bell_val": _np(plan.bell.val),
                "bell_col": _np(plan.bell.col),
                "bell_live_w": _np(plan.bell.live_w),
                "bell_widths": np.asarray(plan.bell.widths, np.int64),
                "meta": np.frombuffer(
                    json.dumps(meta).encode(), dtype=np.uint8),
            }
            if plan.perm is not None:
                arrays["perm"] = np.asarray(plan.perm, np.int64)
            if plan.quantized is not None:
                arrays["q"] = _np(plan.quantized.q)
                arrays["q_minmax"] = np.asarray(
                    [float(plan.quantized.x_min), float(plan.quantized.x_max)],
                    np.float32)
        else:
            meta = {
                "schema": PLAN_SCHEMA_VERSION,
                "kind": "global",
                "config": plan.config.to_dict(),
                "fingerprint": plan.fingerprint,
                "shard_meta": self._shard_meta_json(shard_meta),
                "features_fp": plan.features_fp,
                "num_cols": plan.ell.num_cols,
                "predicted_us": plan.predicted_us,
                "measured_spmm_us": plan.measured_spmm_us,
                "measured_sample_us": plan.measured_sample_us,
                "quant_bits": None if plan.quantized is None
                else plan.quantized.bits,
            }
            arrays = {
                "ell_val": _np(plan.ell.val),
                "ell_col": _np(plan.ell.col),
                "meta": np.frombuffer(
                    json.dumps(meta).encode(), dtype=np.uint8),
            }
            if plan.quantized is not None:
                arrays["q"] = _np(plan.quantized.q)
                arrays["q_minmax"] = np.asarray(
                    [float(plan.quantized.x_min), float(plan.quantized.x_max)],
                    np.float32)
        path = self._path(plan.fingerprint, plan.kind, shard_meta,
                          getattr(plan, "layout", "natural"))
        # np.savez appends ".npz" to names lacking it — keep the tmp name
        # ending in ".npz" so the atomic rename target is what was written.
        tmp = path.with_name(path.name + ".tmp.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, path)
        self._gc_disk(keep=path)

    def _gc_disk(self, keep: Path | None = None) -> None:
        """Bound the disk tier: evict entry files LRU-by-mtime past
        ``max_disk_plans`` (disk hits refresh mtime, so recency tracks use,
        not just write order).  The just-written entry is always kept."""
        if not self.max_disk_plans or self.cache_dir is None:
            return
        def mtime(p: Path) -> float:
            try:
                return p.stat().st_mtime
            except OSError:
                return float("-inf")   # racing process unlinked it already

        entries = [p for p in self.entry_dir.glob("*.npz")
                   if not p.name.endswith(".tmp.npz")]
        entries.sort(key=lambda p: (p != keep, -mtime(p)))
        for p in entries[self.max_disk_plans:]:
            try:
                p.unlink()
                obs.count("plan_cache.disk_gc_evicted")
            except OSError:
                pass  # racing process already collected it

    def _load_disk(self, fingerprint: str, kind: str = "global",
                   shard_meta=None, layout: str = "natural",
                   device=torch.device("cpu")) -> Optional[AnyPlan]:
        path = self._path(fingerprint, kind, shard_meta, layout)
        if not path.exists():
            return None
        try:
            with np.load(path) as z:
                meta = json.loads(bytes(z["meta"].tobytes()).decode())
                # Schema gate: entries written by another layout version —
                # including pre-versioning ones with no stamp — are rejected
                # (treated as a miss), never reinterpreted.
                if meta.get("schema") != PLAN_SCHEMA_VERSION:
                    return None
                if meta.get("kind", "global") != kind:
                    return None
                # A sharded request must get exactly the entry tuned for
                # that (mesh, shard) — a filename collision or hand-renamed
                # file never serves another shard's operand.
                entry_sm = meta.get("shard_meta")
                entry_sm = None if entry_sm is None \
                    else normalize_shard_meta(entry_sm)
                if entry_sm != shard_meta:
                    return None
                if meta.get("layout", "natural") != layout:
                    return None
                quantized = None
                if meta.get("quant_bits") is not None:
                    lo, hi = (float(v) for v in z["q_minmax"])
                    quantized = QuantizedFeatures(
                        q=torch.from_numpy(z["q"]).to(device),
                        x_min=torch.tensor(lo, dtype=torch.float32,
                                           device=device),
                        x_max=torch.tensor(hi, dtype=torch.float32,
                                           device=device),
                        bits=int(meta["quant_bits"]))
                if kind == "block":
                    widths = tuple(int(w) for w in z["bell_widths"])
                    bell = BlockELL(
                        val=torch.from_numpy(z["bell_val"]).to(device),
                        col=torch.from_numpy(z["bell_col"]).to(device),
                        live_w=torch.from_numpy(z["bell_live_w"]).to(device),
                        widths=widths,
                        strategies=tuple(meta["strategies"]),
                        block_rows=int(meta["block_rows"]),
                        num_rows=int(meta["num_rows"]),
                        num_cols=int(meta["num_cols"]))
                    plan = BlockedPlan(
                        bell=bell, backend=str(meta["backend"]),
                        fingerprint=fingerprint,
                        quantized=quantized,
                        features_fp=str(meta.get("features_fp", "")),
                        buckets=tuple(
                            (int(w), tuple(int(i) for i in ids))
                            for w, ids in meta.get("buckets", [])),
                        predicted_us=float(meta.get("predicted_us", 0.0)),
                        measured_spmm_us=float(
                            meta.get("measured_spmm_us", 0.0)),
                        measured_bucket_us=tuple(
                            float(u)
                            for u in meta.get("measured_bucket_us", [])),
                        shard_meta=shard_meta,
                        block_digests=tuple(
                            str(d) for d in meta.get("block_digests", [])),
                        version=int(meta.get("version", 0)),
                        layout=str(meta.get("layout", "natural")),
                        perm=(np.asarray(z["perm"], np.int64)
                              if "perm" in z.files else None),
                        quant_drift=float(meta.get("quant_drift", 0.0)))
                    self._touch(path)
                    return plan
                ell = ELL(torch.from_numpy(z["ell_val"]).to(device),
                          torch.from_numpy(z["ell_col"]).to(device),
                          int(meta["num_cols"]))
            self._touch(path)
            return TunedPlan(
                config=CandidateConfig.from_dict(meta["config"]),
                ell=ell, quantized=quantized, fingerprint=fingerprint,
                features_fp=str(meta.get("features_fp", "")),
                predicted_us=float(meta.get("predicted_us", 0.0)),
                measured_spmm_us=float(meta.get("measured_spmm_us", 0.0)),
                measured_sample_us=float(meta.get("measured_sample_us", 0.0)),
                shard_meta=shard_meta)
        except (OSError, KeyError, ValueError, TypeError,
                json.JSONDecodeError, zipfile.BadZipFile):
            return None  # corrupt entry: treat as miss, tuner will rewrite

    @staticmethod
    def _peek_file(path: Path, fingerprint: str) -> bool:
        """Header-only validity check of one entry file: schema + stored
        fingerprint from the JSON meta, no array deserialization, no mtime
        touch (see ``__contains__``)."""
        try:
            with np.load(path) as z:
                meta = json.loads(bytes(z["meta"].tobytes()).decode())
            return (meta.get("schema") == PLAN_SCHEMA_VERSION
                    and meta.get("fingerprint") == fingerprint)
        except (OSError, KeyError, ValueError, TypeError,
                json.JSONDecodeError, zipfile.BadZipFile):
            return False

    @staticmethod
    def _touch(path: Path) -> None:
        """Refresh a disk entry's mtime on hit — the LRU signal the disk
        GC (``$REPRO_PLAN_CACHE_DISK_MAX``) evicts by."""
        try:
            os.utime(path)
        except OSError:
            pass


_DEFAULT: PlanCache | None = None


def default_cache() -> PlanCache:
    """Process-wide cache backing ``strategy="auto"`` call sites."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = PlanCache()
    return _DEFAULT


def reset_default_cache() -> None:
    global _DEFAULT
    _DEFAULT = None
