"""Per-shard plan building: one tuned ``BlockedPlan`` per serving shard.

Each shard is tuned *independently* on its own remapped CSR and gathered
features — ``repro_torch.tuning.tune_blocked`` wholesale (per-block
ranking, width buckets, optional uint8 quantization) — and cached under
the extended key ``(fingerprint, kind="block", shard_meta)`` with
``shard_meta = (mesh_shape, shard_idx, num_shards)``.  With a disk-backed
cache every restart of the same serving topology is a pure cache hit: no
re-ranking, no re-sampling, no re-quantization.

Incremental maintenance (:func:`apply_edge_updates_sharded`) routes a
global edge delta to the shards that own its rows and patches, re-tunes
or keeps each shard's plan; the halo rebuilds copy only the shard's own
``col_ind`` to the host, never the whole graph.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.graph import CSR, _np
from repro_torch.serving.partition import CSRShard
from repro_torch.tuning.plan_cache import (BlockedPlan, PlanCache,
                                           normalize_shard_meta)


def shard_meta_for(shard: CSRShard,
                   mesh_shape: Sequence[int] | None = None) -> tuple:
    """The cache-key extension for one shard: ``(mesh_shape, shard_idx,
    num_shards)``.  Default mesh shape is the 1-D ``(num_shards,)`` row
    mesh the engine executes on."""
    if mesh_shape is None:
        mesh_shape = (shard.num_shards,)
    return normalize_shard_meta(
        (tuple(mesh_shape), shard.shard_idx, shard.num_shards))


def plan_shard(shard: CSRShard, features, *,
               mesh_shape: Sequence[int] | None = None,
               quant: Optional[int] = None,
               cache: PlanCache | None = None,
               tune_kwargs: dict | None = None) -> BlockedPlan:
    """Tune (or fetch) the ``BlockedPlan`` for one shard.

    Args:
      shard: the partition entry (``partition.partition_csr``).
      features: the *global* dense feature matrix, on the shard CSR's
        device; the shard's operand is gathered here (``shard.gather``) so
        the plan's quantized matrix and ``features_fp`` guard cover exactly
        what serving will feed it.
      mesh_shape: mesh the plan is keyed to (default ``(num_shards,)``).
      quant: pre-quantize the shard operand to this bit width (8/16); the
        plan then serves the fused-dequant path.
      cache / tune_kwargs: forwarded to ``tune_blocked``.

    Returns the shard's plan, with ``plan.shard_meta`` set.  A cached entry
    tuned with a different ``quant``, or whose quantized operand encodes a
    different feature matrix (a stale disk entry), is re-tuned
    (``refresh=True``) and overwritten, never served.
    """
    from repro_torch.tuning.autotune import tune_blocked
    from repro_torch.tuning.plan_cache import features_fingerprint

    kw = dict(tune_kwargs or {})
    if quant is not None:
        kw.setdefault("quant", quant)
    want = kw.get("quant")
    want_bits = getattr(want, "bits", None) if want is not None else None
    if want is not None and want_bits is None:
        want_bits = int(want)
    shard_feats = shard.gather(features) if features is not None else None
    sm = shard_meta_for(shard, mesh_shape)
    plan = tune_blocked(shard.csr, shard_feats, cache=cache, shard_meta=sm,
                        **kw)
    got_bits = plan.quantized.bits if plan.quantized is not None else None
    stale = got_bits != want_bits
    if not stale and want_bits is not None and shard_feats is not None:
        stale = plan.features_fp != features_fingerprint(shard_feats)
    if stale:
        plan = tune_blocked(shard.csr, shard_feats, cache=cache,
                            shard_meta=sm, refresh=True, **kw)
    return plan


def plan_shards(shards: Sequence[CSRShard], features, *,
                mesh_shape: Sequence[int] | None = None,
                quant: Optional[int] = None,
                cache: PlanCache | None = None,
                tune_kwargs: dict | None = None) -> list[BlockedPlan]:
    """Per-shard plans for a whole partition (see :func:`plan_shard`)."""
    return [plan_shard(s, features, mesh_shape=mesh_shape, quant=quant,
                       cache=cache, tune_kwargs=tune_kwargs)
            for s in shards]


# ---------------------------------------------------------------------------
# Incremental maintenance: route edge deltas to the shards owning them.
# ---------------------------------------------------------------------------

def route_edge_deltas(shards: Sequence[CSRShard], additions=(),
                      deletions=()) -> list[tuple[list, list]]:
    """Group global ``(row, col[, val])`` deltas by owning shard.

    The shard whose row range contains ``row`` owns the edge (its
    accumulation is shard-local), so a delta batch fans out into
    independent per-shard delta batches.  Returns one ``(additions,
    deletions)`` pair per shard, in *global* coordinates.
    """
    from repro_torch.core.graph import _parse_deltas

    add_r, add_c, add_v = _parse_deltas(additions, "additions")
    del_r, del_c, _ = _parse_deltas(deletions, "deletions")
    out: list[tuple[list, list]] = []
    for sh in shards:
        a = (add_r >= sh.row_start) & (add_r < sh.row_stop)
        d = (del_r >= sh.row_start) & (del_r < sh.row_stop)
        out.append((
            [(int(r), int(c), float(v)) for r, c, v in
             zip(add_r[a], add_c[a], add_v[a])],
            [(int(r), int(c)) for r, c in zip(del_r[d], del_c[d])],
        ))
    owned = sum(len(a) + len(d) for a, d in out)
    if owned != len(add_r) + len(del_r):
        raise ValueError("deltas reference rows outside every shard's range")
    return out


def _translate_local(shard: CSRShard, entries, *, with_val: bool):
    """Global delta tuples -> shard-local ``(row, col[, val])`` tuples, plus
    the global column ids that are neither local nor in the shard's halo
    (``missing`` — non-empty means the halo must grow first)."""
    n_local = shard.num_local
    halo = shard.halo_ids
    out, missing = [], []
    for e in entries:
        r, c = int(e[0]), int(e[1])
        lr = r - shard.row_start
        if shard.row_start <= c < shard.row_stop:
            lc = c - shard.row_start
        else:
            pos = int(np.searchsorted(halo, c))
            if pos < len(halo) and int(halo[pos]) == c:
                lc = n_local + pos
            else:
                missing.append(c)
                continue
        out.append((lr, lc, float(e[2])) if with_val else (lr, lc))
    return out, missing


def _remapped(shard: CSRShard, cols: np.ndarray, new_halo: np.ndarray):
    """The shard with its local CSR's columns replaced by ``cols`` (host
    int64, in the ``[local | new_halo]`` space) and its halo and gather
    index by ``new_halo``."""
    csr = CSR(shard.csr.row_ptr,
              torch.from_numpy(cols.astype(np.int32)).to(shard.csr.device),
              shard.csr.val, num_cols=shard.num_local + len(new_halo))
    gather = np.concatenate([
        np.arange(shard.row_start, shard.row_stop, dtype=np.int64), new_halo])
    return dataclasses.replace(shard, csr=csr, halo_ids=new_halo,
                               gather_index=gather)


def _extend_halo(shard: CSRShard, new_cols) -> CSRShard:
    """Grow a shard's halo to cover ``new_cols`` (global ids), remapping the
    local CSR's column space and gather index in one vectorized pass.

    Halo ids are kept sorted, so existing halo columns shift to their new
    positions; the shard's per-row edge order (and therefore its SpMM
    accumulation order) is preserved.
    """
    n_local = shard.num_local
    new_halo = np.union1d(shard.halo_ids,
                          np.asarray(sorted(set(new_cols)), np.int64))
    cols = _np(shard.csr.col_ind).astype(np.int64)
    halo_map = n_local + np.searchsorted(new_halo, shard.halo_ids)
    remapped = np.where(cols < n_local, cols,
                        halo_map[np.clip(cols - n_local, 0, None)])
    return _remapped(shard, remapped, new_halo)


def _halo_unreferenced(shard: CSRShard, l_adds, l_dels) -> bool:
    """Would applying these (shard-local) deltas leave any halo column with
    zero referencing edges?  Exact: a deletion removes *every* stored
    instance of its (row, col) pair (``apply_csr_deltas`` semantics), so
    duplicate edges are counted from the CSR itself, not assumed unique."""
    n_local = shard.num_local
    n_halo = len(shard.halo_ids)
    if n_halo == 0 or not l_dels:
        return False
    rp = _np(shard.csr.row_ptr).astype(np.int64)
    cols = _np(shard.csr.col_ind).astype(np.int64)
    ref = np.bincount(cols[cols >= n_local] - n_local, minlength=n_halo)
    for lr, lc in l_dels:
        if lc >= n_local:
            seg = cols[rp[lr]:rp[lr + 1]]
            ref[lc - n_local] -= int((seg == lc).sum())
    for e in l_adds:
        lc = int(e[1])
        if lc >= n_local:
            ref[lc - n_local] += 1
    return bool((ref <= 0).any())


def _compact_halo(shard: CSRShard) -> CSRShard:
    """Drop halo ids no longer referenced by any edge, remapping the local
    CSR's column space and gather index — the shrink counterpart of
    :func:`_extend_halo`.  A no-op when every halo id is still referenced.

    Without this, a long delete stream permanently inflates the per-batch
    cross-shard gather (``gather_index`` keeps ferrying feature rows no
    edge reads).
    """
    n_local = shard.num_local
    cols = _np(shard.csr.col_ind).astype(np.int64)
    used_pos = np.unique(cols[cols >= n_local]) - n_local
    if used_pos.size == len(shard.halo_ids):
        return shard
    new_halo = np.asarray(shard.halo_ids, np.int64)[used_pos]
    remapped = np.where(
        cols < n_local, cols,
        n_local + np.searchsorted(used_pos,
                                  np.clip(cols - n_local, 0, None)))
    return _remapped(shard, remapped, new_halo)


def apply_edge_updates_sharded(shards: Sequence[CSRShard],
                               plans: Sequence[BlockedPlan],
                               additions=(), deletions=(), features=None, *,
                               mesh_shape: Sequence[int] | None = None,
                               quant: Optional[int] = None,
                               cache: PlanCache | None = None,
                               tune_kwargs: dict | None = None):
    """Apply a global edge delta to a sharded serving deployment.

    Each shard owning touched rows is handled by the cheapest sufficient
    path:

      * **patch** — all referenced columns already exist in the shard's
        local+halo space and every halo id stays referenced:
        ``repro_torch.tuning.incremental.apply_edge_updates`` patches the
        shard's plan (touched blocks only, no measurement);
      * **re-tune** — the halo set changes (an addition outside the halo
        grows it, :func:`_extend_halo`; a deletion leaving a halo id
        unreferenced shrinks it, :func:`_compact_halo`): remapped column
        ids shift, so the shard is rebuilt and its plan re-tuned cold
        (``refresh=True``);
      * **untouched** — shards owning no touched rows keep shard and plan
        by identity.

    Args:
      shards / plans: the current deployment (aligned lists).
      additions / deletions: global ``(row, col[, val])`` / ``(row, col)``
        deltas (``repro_torch.core.graph.apply_csr_deltas`` semantics).
      features: the *global* feature matrix (required when plans are
        quantized; each shard patches/re-tunes against its own gather).
      mesh_shape / quant / cache / tune_kwargs: as in :func:`plan_shard` —
        pass the values the deployment was planned with.

    Returns ``(new_shards, new_plans, report)`` where ``report`` maps
    ``"patched"`` / ``"retuned"`` / ``"untouched"`` to shard-index lists,
    ``"halo_shrunk"`` to the (re-tuned) shards whose halo was compacted,
    and ``"reports"`` to the per-shard ``DeltaReport`` of each patched
    shard.
    """
    from repro_torch.tuning.incremental import apply_edge_updates

    kw = dict(tune_kwargs or {})
    if quant is not None:
        kw.setdefault("quant", quant)
    patch_kw = {k: kw[k] for k in ("widths", "strategies", "include_full",
                                   "max_buckets", "accuracy_weight",
                                   "machine") if k in kw}
    routed = route_edge_deltas(shards, additions, deletions)
    new_shards, new_plans = list(shards), list(plans)
    report = {"patched": [], "retuned": [], "untouched": [],
              "halo_shrunk": [], "reports": {}}
    for i, (sh, plan, (adds, dels)) in enumerate(
            zip(shards, plans, routed)):
        if not adds and not dels:
            report["untouched"].append(i)
            continue
        l_adds, missing = _translate_local(sh, adds, with_val=True)
        l_dels, missing_del = _translate_local(sh, dels, with_val=False)
        if missing_del:
            # a deletion's column must already be addressable — otherwise
            # the edge cannot exist in this shard
            raise ValueError(
                f"deletion column(s) {sorted(set(missing_del))[:4]} not in "
                f"shard {i}'s local+halo space (edge not present)")
        sm = shard_meta_for(sh, mesh_shape)
        shrink = _halo_unreferenced(sh, l_adds, l_dels)
        if missing or shrink:
            # the halo set changes: remapped ids shift — rebuild the shard,
            # re-tune cold
            from repro_torch.core.graph import apply_csr_deltas
            from repro_torch.tuning.autotune import tune_blocked

            if missing:
                sh = _extend_halo(sh, missing)
                l_adds, still = _translate_local(sh, adds, with_val=True)
                l_dels, _ = _translate_local(sh, dels, with_val=False)
                if still:
                    raise RuntimeError("halo extension missed columns "
                                       f"{sorted(set(still))[:4]}")
            new_csr, _ = apply_csr_deltas(sh.csr, l_adds, l_dels)
            sh = dataclasses.replace(sh, csr=new_csr)
            if shrink:
                sh = _compact_halo(sh)
                report["halo_shrunk"].append(i)
            feats = sh.gather(features) if features is not None else None
            new_plans[i] = tune_blocked(sh.csr, feats, cache=cache,
                                        shard_meta=sm, refresh=True, **kw)
            new_shards[i] = sh
            report["retuned"].append(i)
        else:
            feats = sh.gather(features) if features is not None else None
            patched, new_csr, rep = apply_edge_updates(
                plan, sh.csr, l_adds, l_dels, features=feats,
                cache=cache, **patch_kw)
            new_plans[i] = patched
            new_shards[i] = dataclasses.replace(sh, csr=new_csr)
            report["patched"].append(i)
            report["reports"][i] = rep
    return new_shards, new_plans, report
