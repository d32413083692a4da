"""`GNNServer`: sharded, micro-batched GNN inference over per-shard plans.

The single-call path (``aes_spmm``/``gnn.evaluate``) tunes one plan and
runs it.  This engine turns that into a serving loop over a row
partition:

  partition (``partition.py``)   1-D row shards + halo gather index
  per-shard plans (``plans.py``) ``tune_blocked`` per shard, cached under
                                 ``(fingerprint, "block", shard_meta)``
  execution (this module)        per request batch: gather each shard's
                                 operand, run its width-bucketed plan
                                 (``block_ell_spmm`` on the card), concat
                                 the row outputs

Execution is the reference package's loop mode: one launch per shard on a
round-robin device assignment (``repro_torch.distributed.shard_devices``),
with the *next* shard's operand gathered before the current shard's
compute is consumed.  Shards may share a device — one card serves a
4-shard layout, and the double buffering is then plain sequencing.  The
reference's ``mode="spmd"`` (one ``shard_map`` program, one device per
shard) belongs to the multi-card slice of the port and raises
``NotImplementedError``.

Micro-batching: ``submit()`` enqueues requests, ``flush()`` executes the
whole queue in as few sharded passes as possible — SpMM is linear in the
dense operand's columns, so all float requests are served by **one**
column-concatenated pass, and requests for the graph's own feature matrix
(``x=None``) dedupe into a single pass over the cached (possibly
quantized) per-shard operands.  ``run_batch()`` is the same execution
path without the queue: it only enqueues work on the current CUDA stream
and never waits for the card, so the continuous-batching runtime
(``repro_torch.serving.runtime``) can assemble the next batch while this
one runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.aes_spmm import not_ported
from repro_torch.core.graph import CSR
from repro_torch.distributed.serving import shard_devices
from repro_torch.serving.partition import (concat_shard_outputs, halo_stats,
                                           partition_csr)
from repro_torch.serving.plans import plan_shards
from repro_torch.tuning.plan_cache import BlockedPlan, PlanCache, default_cache


def _plan_to(plan: BlockedPlan, device: torch.device) -> BlockedPlan:
    """The plan with its operand tensors on ``device`` (itself when they
    are there already)."""
    if plan.bell.val.device == device:
        return plan
    bell = plan.bell._replace(val=plan.bell.val.to(device),
                              col=plan.bell.col.to(device),
                              live_w=plan.bell.live_w.to(device))
    q = plan.quantized
    if q is not None:
        q = q._replace(q=q.q.to(device), x_min=q.x_min.to(device),
                       x_max=q.x_max.to(device))
    return dataclasses.replace(plan, bell=bell, quantized=q)


def _warm(plan: BlockedPlan) -> None:
    """Make now every copy from the host that a request would otherwise
    trigger on first use: the blocked kernel's launch table and a permuted
    plan's inverse permutation, each memoized (see ``run_batch``)."""
    from repro_torch.kernels import ops

    ops.prepare_block_ell(plan.bell, plan.buckets or None)
    plan.inv_perm()


class GNNServer:
    """Sharded, batched GNN inference engine over per-shard plans.

    Args:
      csr: the adjacency (e.g. ``dataset.gcn_adj``).
      features: the graph's dense node-feature matrix ``[num_nodes, F]``
        — tuned against, optionally pre-quantized into the per-shard
        plans, and served by ``submit(x=None)`` requests.
      num_shards: row shards (default: one per device of the server's
        device type — 1 on a one-card machine).
      mode: ``"loop"`` (per-shard launches).  ``"spmd"`` raises
        ``NotImplementedError``: it comes with the multi-card slice.
      quant: pre-quantize each shard's operand to this bit width (8/16);
        serving then moves uint8 features and fuses Eq. 2 into the gather.
      cache: plan cache (default process-wide).  Point it at a disk dir
        and a restarted server re-assembles every shard plan from disk
        without re-tuning.
      tune_kwargs: forwarded to each shard's ``tune_blocked`` call.
      devices: the devices shards are placed on, round robin (default:
        every CUDA device; a missing card raises).  ``csr`` and
        ``features`` are copied to the first one, where the shards are
        partitioned and tuned; pass ``devices=["cpu"]`` to serve on the
        CPU through the kernels' plain versions.

    Serving API: ``submit(x=None) -> ticket``, ``flush() -> [results]``,
    or ``aggregate(x=None)`` for a one-shot request.  ``x=None`` requests
    the aggregation of the server's own feature matrix (the cached —
    possibly quantized — fast path); a dense ``[num_nodes, F]`` operand (a
    hidden-layer activation, an updated table) takes the float path.
    """

    def __init__(self, csr: CSR, features, *,
                 num_shards: Optional[int] = None,
                 mode: str = "loop",
                 quant: Optional[int] = None,
                 cache: Optional[PlanCache] = None,
                 tune_kwargs: Optional[dict] = None,
                 devices=None):
        if mode not in ("loop", "spmd"):
            raise ValueError(f"unknown mode {mode!r} "
                             "(expected 'loop' or 'spmd')")
        if mode == "spmd":
            raise not_ported('GNNServer(mode="spmd")', "multi-card serving")
        self.device = shard_devices(1, devices)[0]
        if num_shards is None:
            same_kind = torch.cuda.device_count() \
                if self.device.type == "cuda" else 1
            num_shards = min(same_kind, csr.num_rows)
        self.mode = mode
        self.num_shards = int(num_shards)
        self.cache = cache if cache is not None else default_cache()
        self.features = torch.as_tensor(features, dtype=torch.float32,
                                        device=self.device)
        self.shards = partition_csr(csr.to(self.device), self.num_shards)
        self.mesh_shape = (self.num_shards,)
        self._quant = quant
        self._tune_kwargs = dict(tune_kwargs or {})
        self._requested_devices = devices
        self.plans = plan_shards(
            self.shards, self.features, mesh_shape=self.mesh_shape,
            quant=quant, cache=self.cache, tune_kwargs=tune_kwargs)
        self._prepare_execution()

        self._queue: list = []
        self._closed = False
        self.stats = {"requests": 0, "flushes": 0, "sharded_passes": 0,
                      "rows_served": 0, "resident_dedupes": 0,
                      "edge_updates": 0}

    def _prepare_execution(self) -> None:
        """(Re)build the execution state from the current ``self.shards``
        / ``self.plans`` — called at init and again after
        :meth:`apply_edge_updates` swaps patched shards/plans in.

        One-time tuned-operand verification per shard, so the request hot
        path never hashes: a quantized plan whose ``features_fp`` matches
        the shard's gather (one host hash of it) serves its uint8 operand
        directly; one tuned on *other* features (a stale disk entry) has
        its quantized operand dropped from this server's copy and serves
        the float path.  Then every plan is warmed (:func:`_warm`), so a
        request copies nothing from the host.
        """
        from repro_torch.tuning.plan_cache import features_fingerprint

        self._devices = shard_devices(self.num_shards,
                                      self._requested_devices)
        self.plans = [_plan_to(p, d)
                      for p, d in zip(self.plans, self._devices)]
        self._resident = []
        for i, (s, d) in enumerate(zip(self.shards, self._devices)):
            plan = self.plans[i]
            gathered = s.gather(self.features)
            if plan.quantized is not None:
                if features_fingerprint(gathered) == plan.features_fp:
                    self._resident.append(None)   # uint8 operand serves
                    continue
                self.plans[i] = dataclasses.replace(
                    plan, quantized=None, features_fp="")
            self._resident.append(gathered.to(d))
        # Dense (non-resident) requests can never match a quantized plan's
        # tuned operand — serve them through a quantless view so the hot
        # path skips the content hash entirely.
        self._float_plans = [
            dataclasses.replace(p, quantized=None, features_fp="")
            if p.quantized is not None else p for p in self.plans]
        for p in self.plans + self._float_plans:
            _warm(p)
        for s in self.shards:
            s.index_on(self.device)

    def apply_edge_updates(self, additions=(), deletions=()) -> dict:
        """Patch the live deployment for a graph edge delta.

        Routes the global delta to the shards owning the touched rows
        (``repro_torch.serving.plans.apply_edge_updates_sharded``): those
        shards' plans are patched (or, when the halo changes, re-tuned),
        every other shard's plan is untouched, and the execution state is
        rebuilt from the swapped-in shards/plans.  Pending submitted
        tickets are served by the *patched* graph at the next ``flush()``.

        Returns the routing report (patched/retuned/untouched/halo_shrunk
        shard ids + per-shard ``DeltaReport``\\s).
        """
        from repro_torch.serving.plans import apply_edge_updates_sharded

        self.shards, self.plans, report = apply_edge_updates_sharded(
            self.shards, self.plans, additions, deletions,
            features=self.features, mesh_shape=self.mesh_shape,
            quant=self._quant, cache=self.cache,
            tune_kwargs=self._tune_kwargs)
        self._prepare_execution()
        self.stats["edge_updates"] += 1
        return report

    # -- submission ------------------------------------------------------

    def validate_operand(self, x):
        """Validate one request operand at enqueue time, returning its
        ``float32`` tensor on the server's device (``None`` passes
        through: the cached features).

        Rejections happen here — before the request is admitted — with a
        ``ValueError`` naming the problem: a closed server, a non-real
        dtype (complex/object/strings cannot be aggregated), a non-2D
        operand, or a feature-dim (node-count) mismatch.
        """
        if self._closed:
            raise ValueError("server is closed (no further submissions)")
        if x is None:
            return None
        if isinstance(x, torch.Tensor):
            dtype, real = x.dtype, not (x.is_complex() or x.is_quantized)
        else:
            x = np.asarray(x)
            dtype = x.dtype
            real = (np.issubdtype(dtype, np.floating)
                    or np.issubdtype(dtype, np.integer)
                    or np.issubdtype(dtype, np.bool_))
        if not real:
            raise ValueError(
                f"operand dtype {dtype} is not a real numeric dtype "
                "(expected float/int/bool, castable to float32)")
        if x.ndim != 2:
            raise ValueError(
                f"operand must be 2-D [num_nodes, F], got ndim={x.ndim}")
        if int(x.shape[0]) != int(self.features.shape[0]):
            raise ValueError(
                f"operand shape {tuple(x.shape)} does not match "
                f"[num_nodes={self.features.shape[0]}, F]")
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _is_resident_operand(self, x) -> bool:
        """True when ``x`` is (content-equal to) the server's own feature
        matrix, so that an equal-but-distinct copy (a round trip through
        numpy, a deserialized request payload) still takes the
        cached/quantized fast path.

        The reference package compares content hashes of the two float32
        matrices on the host.  Here the same decision is made on the card:
        after the same shape gate, ``x`` and the features are compared bit
        for bit (as int32 words), with no host copy.  Only a hash collision
        could tell the two apart.
        """
        if x is self.features:
            return True
        if tuple(x.shape) != tuple(self.features.shape) \
                or x.dtype != self.features.dtype:
            return False
        return torch.equal(x.view(torch.int32),
                           self.features.view(torch.int32))

    def submit(self, x=None) -> int:
        """Enqueue a request; returns its ticket (index into the next
        ``flush()`` result list).  Invalid operands and post-``close()``
        submissions raise ``ValueError`` here, at enqueue time.

        A dense operand content-equal to the server's feature matrix is
        deduped to the ``x=None`` fast path (see
        :meth:`_is_resident_operand`)."""
        x = self.validate_operand(x)
        if x is not None and self._is_resident_operand(x):
            self.stats["resident_dedupes"] += 1
            x = None
        ticket = len(self._queue)
        self._queue.append(x)
        return ticket

    def run_batch(self, batch: Sequence) -> list:
        """Execute one micro-batch of operands *without waiting for the
        card*: returns one ``[num_rows, F_i]`` tensor per entry, in order,
        whose work is enqueued on the current CUDA stream (callers that
        need the values synchronize that stream, or record an event on it
        and wait for the event).

        ``flush()`` is a thin wrapper over it, and the continuous-batching
        runtime calls it directly so the next batch can be assembled while
        this one runs.  All float operands ride one column-concatenated
        sharded pass (SpMM is linear in B's columns); ``None`` entries
        dedupe into one pass over the cached, possibly quantized, per-shard
        operands.
        """
        batch = list(batch)
        if not batch:
            return []
        self.stats["requests"] += len(batch)
        self.stats["flushes"] += 1
        return self._run_batch_inner(batch)

    @obs.traced("engine.run_batch")
    def _run_batch_inner(self, batch: list) -> list:
        results: list = [None] * len(batch)
        dense = [(t, x) for t, x in enumerate(batch) if x is not None]
        if any(x is None for x in batch):
            out = self._run(None)
            for t, x in enumerate(batch):
                if x is None:
                    results[t] = out
        if dense:
            widths = [int(x.shape[1]) for _, x in dense]
            cat = self._run(torch.cat([x for _, x in dense], dim=1)
                            if len(dense) > 1 else dense[0][1])
            off = 0
            for (t, _), w in zip(dense, widths):
                results[t] = cat[:, off:off + w]
                off += w
        self.stats["rows_served"] += \
            int(self.features.shape[0]) * len(batch)
        return results

    def flush(self) -> list:
        """Execute the queued micro-batch; returns one ``[num_rows, F_i]``
        result per ticket, in submission order (see :meth:`run_batch`)."""
        queue, self._queue = self._queue, []
        return self.run_batch(queue)

    def close(self) -> list:
        """Drain: execute any pending micro-batch, then refuse further
        submissions (``submit`` raises ``ValueError``).  Returns the
        drained results (empty when nothing was pending).  Idempotent."""
        results = self.flush() if self._queue else []
        self._closed = True
        return results

    def aggregate(self, x=None):
        """One-shot request, independent of the micro-batch queue: any
        tickets already submitted stay pending for the next ``flush()``."""
        pending, self._queue = self._queue, []
        try:
            ticket = self.submit(x)
            return self.flush()[ticket]
        finally:
            self._queue = pending

    # -- execution -------------------------------------------------------

    def _run(self, x):
        self.stats["sharded_passes"] += 1
        return self._run_loop(x)

    def _operand(self, s: int, x):
        if x is None:
            return self._resident[s]
        return self.shards[s].gather(x).to(self._devices[s])

    def _run_loop(self, x):
        """Per-shard launches with double-buffered operand dispatch: shard
        ``s+1``'s gather is issued before shard ``s``'s compute is
        consumed.  ``x=None`` requests run ``assume_tuned`` — the init-time
        verification already pinned each resident operand to its plan, so
        no per-request content hashing happens here."""
        from repro_torch.exec import default_executor

        executor = default_executor()
        plans = self.plans if x is None else self._float_plans
        outs = []
        cur = self._operand(0, x)
        for s in range(self.num_shards):
            nxt = self._operand(s + 1, x) if s + 1 < self.num_shards \
                else None
            outs.append(executor.run_plan(plans[s], cur,
                                          assume_tuned=x is None))
            cur = nxt
        return concat_shard_outputs(outs, self.device)

    # -- introspection ---------------------------------------------------

    def halo_stats(self) -> dict:
        """Partition quality: halo rows gathered per shard."""
        return halo_stats(self.shards)

    def plan_summary(self) -> list[dict]:
        """Per-shard plan digest for reports and the ``--smoke`` CLI."""
        out = []
        for sh, p in zip(self.shards, self.plans):
            out.append({
                "shard": sh.shard_idx,
                "rows": sh.num_rows,
                "halo": sh.num_halo,
                "blocks": p.bell.num_blocks,
                "layout": p.row_layout,
                "widths": list(p.bell.widths),
                "buckets": [[w, len(ids)] for w, ids in p.buckets],
                "quant_bits": None if p.quantized is None
                else p.quantized.bits,
                "shard_meta": {"mesh": list(p.shard_meta[0]),
                               "shard": p.shard_meta[1],
                               "of": p.shard_meta[2]},
            })
        return out
