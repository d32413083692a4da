"""Incremental plan maintenance: patch a cached ``BlockedPlan`` in place
of a whole-graph re-tune when the graph's edges change.

A ``BlockedPlan`` has three kinds of locality a patch exploits:

  * **block locality** — the (strategy, width) table is per row block, so
    an edge delta re-ranks and re-samples only the blocks owning touched
    rows; the other segments are kept as views of the cached operand;
  * **fingerprint locality** — the plan-cache key combines fixed-size
    per-block content digests (``core.graph.csr_block_digests``), so the
    patched key re-digests only touched digest blocks and lands on the
    fingerprint a cold tune of the patched graph computes;
  * **quantization locality** — the prepared uint operand keeps its global
    (x_min, x_max), so a feature update re-encodes only the touched rows
    (``core.quantization.requantize_rows``).

Per-block ranking is analytic and deterministic (``cost_model.rank`` over
``autotune.block_grid``, the grid ``tune_blocked`` ranks over), so a
patched natural-layout plan is bit-identical to a cold ``tune_blocked`` of
the patched graph with bucket measurement off: configs, operand bytes,
buckets and fingerprint.  Degree-sorted plans compose deltas through their
stored permutation, frozen at tune time (re-deriving it from the patched
degrees would reshuffle every block); their fingerprint stays the
natural-order one and their outputs are restored to natural order by the
executor.  A patch skips what makes a cold tune slow: hashing the whole
CSR, extracting and ranking untouched blocks, re-sampling their segments,
re-quantizing every row, and all measurement.

Everything runs on the CSR's device: the delta merge
(``core.graph.apply_csr_deltas``), the re-sampling of touched blocks and
the splice, which keeps untouched segments as views and joins the pieces
with one ``torch.cat``.  What crosses to the host is the delta, a few
scalars, the touched blocks' ``row_ptr`` slices (their features) and the
touched digest blocks' slices (their hash).

The patched plan is written through ``PlanCache.put``; its disk tier
stages a temporary file and ``os.replace``s it over the entry, so a
concurrent loader sees the old version or the new one (``version`` counts
applied patches).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.graph import (DIGEST_BLOCK_ROWS, BlockELL,
                                    apply_csr_deltas, combine_block_digests,
                                    csr_block_digests,
                                    partition_width_buckets,
                                    permute_csr_rows)
from repro_torch.core.quantization import (DRIFT_THRESHOLD, quantize,
                                           range_drift, requantize_rows)
from repro_torch.core.sampling import sample_block_segment
from repro_torch.tuning import calibration, cost_model
from repro_torch.tuning import features as features_mod
from repro_torch.tuning.autotune import block_grid
from repro_torch.tuning.cost_model import DEFAULT_WIDTHS, MachineModel
from repro_torch.tuning.plan_cache import (BlockedPlan, PlanCache,
                                           features_fingerprint)


@dataclass(frozen=True)
class DeltaReport:
    """What one ``apply_edge_updates`` call did."""

    num_additions: int
    num_deletions: int
    touched_rows: int
    touched_blocks: tuple       # plan blocks re-ranked + re-sampled
    num_blocks: int             # total plan blocks (for the skipped ratio)
    touched_digest_blocks: tuple  # fingerprint digests recomputed
    requantized_rows: int
    fingerprint: str            # the patched plan's (new) cache key
    version: int                # the patched plan's version
    quant_drift: float = 0.0    # worst feature-range drift carried so far
    requant_refreshed: bool = False  # drift crossed the threshold: the
    # quantization range was re-derived and the full operand re-encoded

    @property
    def blocks_skipped(self) -> int:
        return self.num_blocks - len(self.touched_blocks)


def _splice_block_ell(bell: BlockELL, csr, new_configs: dict) -> BlockELL:
    """Rebuild a BlockELL replacing only the blocks in ``new_configs``
    (block id -> (strategy, width)); every other segment is a view of the
    cached operand, and one ``torch.cat`` joins the pieces on its device.

    Bit-equivalent to a cold ``sample_csr_to_block_ell`` of ``csr`` with
    the merged config table: untouched rows keep byte-identical
    ``col_ind``/``val`` slices (``apply_csr_deltas`` guarantees it) and
    every sampler addresses the edge arrays relative to the block's
    ``row_ptr`` slice, so shifted offsets gather the same content.
    """
    br = bell.block_rows
    offsets = bell.slot_offsets()
    vals, cols, lives, widths, strategies = [], [], [], [], []
    for b in range(bell.num_blocks):
        if b in new_configs:
            strat, width = new_configs[b]
            v, c, live, w, s = sample_block_segment(
                csr, None, b, strat, width, br)
            v, c = v.reshape(-1), c.reshape(-1)
        else:
            off, w, s = offsets[b], bell.widths[b], bell.strategies[b]
            v = bell.val[off:off + br * w]
            c = bell.col[off:off + br * w]
            live = bell.live_w[b * br:(b + 1) * br]
        vals.append(v)
        cols.append(c)
        lives.append(live)
        widths.append(w)
        strategies.append(s)
    max_w = max(widths)
    vals.append(bell.val.new_zeros(max_w))
    cols.append(bell.col.new_zeros(max_w))
    return BlockELL(
        val=torch.cat(vals), col=torch.cat(cols), live_w=torch.cat(lives),
        widths=tuple(widths), strategies=tuple(strategies), block_rows=br,
        num_rows=csr.num_rows, num_cols=csr.num_cols)


@obs.traced("incremental.apply_edge_updates")
def apply_edge_updates(plan: BlockedPlan, csr, additions=(), deletions=(),
                       *, features=None, requant_rows=(),
                       widths=DEFAULT_WIDTHS,
                       strategies=("aes", "afs", "sfs"),
                       include_full: bool = True,
                       max_buckets: int = 3,
                       machine: MachineModel | None = None,
                       accuracy_weight: float = 5.0,
                       cache: PlanCache | None = None,
                       verbose: bool = False):
    """Patch a cached ``BlockedPlan`` for a CSR edge delta.

    Args:
      plan: the cached plan for ``csr`` (``kind="block"``).
      csr: the CSR the plan was tuned for (the *pre*-delta graph).
      additions / deletions: edge deltas, ``(row, col[, val])`` /
        ``(row, col)`` tuples with the semantics of
        :func:`~repro_torch.core.graph.apply_csr_deltas` (strict: every
        delta must change the graph).
      features: the dense feature matrix (current values, i.e. already
        updated when ``requant_rows`` is passed), on the plan's device.
        Only consulted for its width (the cost model's ``feat_dim``) and
        for re-quantization; required when the plan is quantized.
      requant_rows: feature rows whose values changed since the plan was
        quantized — only these rows of the prepared uint operand are
        re-encoded, with the stored global (x_min, x_max) range, unless
        the accumulated range drift passes ``DRIFT_THRESHOLD`` (then the
        whole operand is re-quantized with a fresh range).
      widths / strategies / include_full / max_buckets / accuracy_weight:
        the tuning grid — pass the *same* knobs the plan was tuned with,
        or the patched blocks' decisions diverge from a cold re-tune.
      machine: cost model (default: the calibrated model, as in
        ``tune_blocked``).
      cache: when given, the patched plan is ``put()`` under its new
        fingerprint — an atomic versioned swap on the disk tier.

    Returns ``(new_plan, new_csr, report)``.  ``new_plan.version`` is
    ``plan.version + 1`` and its fingerprint, configs and operand bytes
    equal a cold ``tune_blocked(new_csr, ...)`` with the same grid
    (measurement fields are zeroed: a patch never measures, and it keeps
    the plan's bucket partition where the widths did not change).  A
    no-op delta (empty additions, deletions and requant_rows) returns
    ``plan`` and ``csr`` themselves.
    """
    if plan.kind != "block":
        raise ValueError("apply_edge_updates patches BlockedPlans only "
                         "(global TunedPlans have no block table)")
    bell = plan.bell
    if bell.num_rows != csr.num_rows or bell.num_cols != csr.num_cols:
        raise ValueError(
            f"plan shape ({bell.num_rows}, {bell.num_cols}) does not match "
            f"csr shape ({csr.num_rows}, {csr.num_cols})")

    # Base digests: from the plan when it carries them (cheap consistency
    # check against its fingerprint), else one full digest pass over the
    # pre-delta CSR, which doubles as a wrong-graph guard.
    if plan.block_digests:
        digests = list(plan.block_digests)
    else:
        digests = csr_block_digests(csr)
    if combine_block_digests(
            digests, csr.num_rows, csr.num_cols) != plan.fingerprint:
        raise ValueError("plan fingerprint does not match this CSR — "
                         "apply_edge_updates needs the exact pre-delta "
                         "graph the plan was tuned for")

    qf = plan.quantized
    quant_bits = qf.bits if qf is not None else None
    requant_rows = np.asarray(list(requant_rows), np.int64)
    if quant_bits is not None and features is None:
        raise ValueError("patching a quantized plan requires the current "
                         "feature matrix (pass `features=`)")
    if requant_rows.size and qf is None:
        raise ValueError("requant_rows given but the plan is not quantized")

    additions, deletions = list(additions), list(deletions)
    new_csr, touched = apply_csr_deltas(csr, additions, deletions)

    if touched.size == 0 and requant_rows.size == 0:
        obs.count("incremental.noop_patches")
        return plan, csr, DeltaReport(
            num_additions=0, num_deletions=0, touched_rows=0,
            touched_blocks=(), num_blocks=bell.num_blocks,
            touched_digest_blocks=(), requantized_rows=0,
            fingerprint=plan.fingerprint, version=plan.version)

    # -- fingerprint: re-digest only touched digest blocks ----------------
    tdig = tuple(int(b) for b in np.unique(touched // DIGEST_BLOCK_ROWS))
    # Wrong-graph guard: with the plan's own digests the fingerprint check
    # above is a tautology, so verify the touched blocks (re-digested
    # anyway) against the pre-delta CSR before trusting them.
    if plan.block_digests:
        for b, d in zip(tdig, csr_block_digests(csr, blocks=tdig)):
            if digests[b] != d:
                raise ValueError(
                    f"digest block {b} of this CSR does not match the "
                    "plan — apply_edge_updates needs the exact pre-delta "
                    "graph the plan was tuned for")
    for b, d in zip(tdig, csr_block_digests(new_csr, blocks=tdig)):
        digests[b] = d
    new_fp = combine_block_digests(digests, new_csr.num_rows,
                                   new_csr.num_cols)

    # -- re-rank + re-sample only touched plan blocks ---------------------
    # A degree-sorted plan maps touched natural rows to their positions
    # under the stored perm; the fingerprint above stays natural-order.
    if plan.perm is not None:
        perm = np.asarray(plan.perm, np.int64)
        inv_perm = np.empty_like(perm)
        inv_perm[perm] = np.arange(perm.size, dtype=np.int64)
        splice_csr = permute_csr_rows(new_csr, perm)
        tblk = tuple(int(b) for b in
                     np.unique(inv_perm[touched] // bell.block_rows))
    else:
        splice_csr = new_csr
        tblk = tuple(int(b) for b in np.unique(touched // bell.block_rows))
    # 64: tune_blocked's synthetic stand-in width
    feat_dim = int(features.shape[1]) if features is not None else 64
    if machine is None:
        machine = calibration.calibrated_machine_model() or MachineModel()
    grid = block_grid(plan.backend, quant_bits, strategies, widths,
                      include_full)
    new_configs = {}
    for b, bf in zip(tblk, features_mod.extract_block_features(
            splice_csr, bell.block_rows, feat_dim=feat_dim, blocks=tblk)):
        best = cost_model.rank(bf, grid, machine, accuracy_weight)[0]
        new_configs[b] = (best.config.strategy, best.config.sh_width)
        if verbose:
            print(f"  patch block {b:4d} rows={bf.num_rows} nnz={bf.nnz} "
                  f"-> {best.config.key()}")

    new_bell = _splice_block_ell(bell, splice_csr, new_configs) if tblk \
        else bell
    # the analytic bucket choice of tune_blocked without measurement
    # (finest partition within the launch budget); unchanged widths keep
    # the plan's own, possibly measured, partition
    buckets = plan.buckets
    if new_bell.widths != bell.widths:
        buckets = partition_width_buckets(new_bell.widths, max_buckets)

    # -- re-quantize only touched feature rows ----------------------------
    new_qf, new_ffp = qf, plan.features_fp
    quant_drift = plan.quant_drift
    requant_refreshed = False
    if requant_rows.size:
        features = torch.as_tensor(features, dtype=torch.float32)
        # The worst drift seen so far: gradual drift can stay in range on
        # every patch while the data moves to a sliver of the span (or
        # past it, clipping); past the threshold the whole operand is
        # re-encoded against a freshly derived range.
        quant_drift = max(quant_drift, range_drift(qf, features))
        if quant_drift > DRIFT_THRESHOLD:
            new_qf = quantize(features, qf.bits)
            quant_drift = 0.0
            requant_refreshed = True
            obs.count("incremental.requant_refreshed")
        else:
            rows = torch.as_tensor(requant_rows, device=features.device)
            new_qf = requantize_rows(qf, requant_rows, features[rows])
        new_ffp = features_fingerprint(features)

    new_plan = replace(
        plan, bell=new_bell, fingerprint=new_fp,
        block_digests=tuple(digests), version=plan.version + 1,
        buckets=buckets, quantized=new_qf, features_fp=new_ffp,
        quant_drift=quant_drift,
        predicted_us=0.0, measured_spmm_us=0.0, measured_bucket_us=())
    if cache is not None:
        cache.put(new_plan)
    if obs.enabled():
        obs.count("incremental.patches")
        obs.count("incremental.blocks_touched", len(tblk))
        obs.count("incremental.blocks_skipped",
                  new_bell.num_blocks - len(tblk))
        obs.count("incremental.digest_blocks_touched", len(tdig))
        obs.count("incremental.requantized_rows", int(requant_rows.size))
    return new_plan, new_csr, DeltaReport(
        num_additions=len(additions), num_deletions=len(deletions),
        touched_rows=int(touched.size), touched_blocks=tblk,
        num_blocks=new_bell.num_blocks, touched_digest_blocks=tdig,
        requantized_rows=int(requant_rows.size),
        fingerprint=new_fp, version=new_plan.version,
        quant_drift=float(quant_drift),
        requant_refreshed=requant_refreshed)
