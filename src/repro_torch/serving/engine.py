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

Two execution modes, the reference package's:

  * ``mode="loop"`` — one launch per shard on a round-robin device
    assignment (``repro_torch.distributed.shard_devices``), with the
    *next* shard's operand gathered before the current shard's compute is
    consumed.  Shards may share a device — one card serves a 4-shard
    layout, and the double buffering is then plain sequencing.
  * ``mode="spmd"`` — one pass over every shard at once.  The reference
    runs one ``shard_map`` program over a ``("shards",)`` mesh, one device
    per shard.  Here the shards split in shard order over device slots
    (``repro_torch.distributed.serving_mesh``), and each slot's shards are
    stacked on its device: their BlockELL blocks form one BlockELL and
    their operands one ``[shards * gcap, F]`` matrix, so a slot's pass is
    one ``block_ell_spmm`` launch per non-empty *global* width bucket (at
    most ``max_buckets``), where loop mode makes one per shard per bucket
    (:class:`_SpmdBundle`).  The slots run in order and their outputs are
    gathered, device to device, on the first slot's device.

Micro-batching: ``submit()`` enqueues requests, ``flush()`` executes the
whole queue in as few sharded passes as possible — SpMM is linear in the
dense operand's columns, so all float requests are served by **one**
column-concatenated pass, and requests for the graph's own feature matrix
(``x=None``) dedupe into a single pass over the cached (possibly
quantized) per-shard operands.  ``run_batch()`` is the same execution
path without the queue: it only enqueues work on the current CUDA stream
of each card it uses (a copy between cards is ordered on both cards'
current streams) and never waits for a card, so the continuous-batching
runtime (``repro_torch.serving.runtime``) can assemble the next batch
while this one runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.graph import (CSR, BlockELL, buckets_within,
                                    partition_width_buckets)
from repro_torch.distributed.serving import serving_mesh, shard_devices
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


def _stack_block_ells(bells, gcap: int) -> BlockELL:
    """One BlockELL of every shard's blocks in shard order, over the
    operand stack whose shard ``s`` starts at row ``s * gcap``: live slots
    (``k < live_w`` of their row) get ``s * gcap`` added to their column,
    dead slots keep ``(0, 0.0)``.  Its rows are all the blocks' rows,
    padded ones included."""
    dev, br = bells[0].val.device, bells[0].block_rows
    widths = tuple(w for b in bells for w in b.widths)
    blocks = torch.tensor([b.num_blocks for b in bells], device=dev)
    val = torch.cat([b.val[:b.total_slots] for b in bells]
                    + [bells[0].val.new_zeros(max(widths))])
    col = torch.cat([b.col[:b.total_slots] for b in bells]
                    + [bells[0].col.new_zeros(max(widths))])
    live_w = torch.cat([b.live_w for b in bells])
    # each slot's stacked row, its index k within the row, the row's shard
    row_w = torch.tensor(widths, dtype=torch.int64,
                         device=dev).repeat_interleave(br)
    slot_row = torch.repeat_interleave(
        torch.arange(row_w.numel(), device=dev), row_w)
    k = torch.arange(slot_row.numel(), device=dev) \
        - (torch.cumsum(row_w, 0) - row_w)[slot_row]
    row_shard = torch.repeat_interleave(
        torch.arange(len(bells), device=dev), blocks * br)
    n = slot_row.numel()
    col[:n] = torch.where(
        k < live_w[slot_row].long(),
        col[:n] + (row_shard[slot_row] * gcap).to(torch.int32), col[:n])
    return BlockELL(val, col, live_w, widths,
                    tuple(st for b in bells for st in b.strategies), br,
                    row_w.numel(), len(bells) * gcap)


def _spmd_slots(shards, plans, features, mesh, max_buckets: int = 3
                ) -> list:
    """One :class:`_SpmdBundle` per slot of ``mesh``, after the checks and
    decisions that hold across every shard, as in the reference package's
    ``_SpmdBundle``: no degree-sorted plan, one ``block_rows``, the width
    buckets' bounds from one ``partition_width_buckets`` call over every
    shard's block widths, and a quantized resident operand only when every
    shard's plan is quantized (one dtype across shards) and verifiably
    encodes the shard's gathered features (the one-time ``features_fp``
    check loop mode makes)."""
    for p in plans:
        if p.perm is not None:
            # the stacked rows assume block b's rows land at [b*br,
            # (b+1)*br) in natural order; a degree-sorted plan's land at
            # perm[those] and would need a per-shard inverse gather
            raise ValueError(
                "spmd mode does not support degree-sorted (row-"
                "permuted) plans; use mode='loop' or layout='natural'")
    brs = {p.bell.block_rows for p in plans}
    if len(brs) != 1:
        raise ValueError(f"spmd mode needs one block_rows, got {brs}")
    bounds = tuple(bw for bw, _ in partition_width_buckets(
        [w for p in plans for w in p.bell.widths], max_buckets))
    from repro_torch.tuning.plan_cache import features_fingerprint

    qs = [p.quantized for p in plans]
    quant = all(
        q is not None and q.q.dtype == qs[0].q.dtype
        and features_fingerprint(s.gather(features)) == p.features_fp
        for s, p, q in zip(shards, plans, qs))
    return [_SpmdBundle(shards[lo:hi], plans[lo:hi], features, dev, bounds,
                        quant)
            for dev, (lo, hi) in zip(mesh.devices, mesh.groups)]


class _SpmdBundle:
    """One slot's shards stacked on its device, served by one blocked pass.

    Built by :func:`_spmd_slots`, which makes the choices that hold across
    slots: the global width buckets' ``bounds`` and ``quant``, whether the
    resident operand is the quantized stack.  The layout is this port's:

      * the slot's blocks, in shard order, form one :class:`BlockELL`, so
        its shard ``s``'s local row ``r`` is stacked row ``blk_off[s] *
        block_rows + r``;
      * shard ``s``'s operand occupies rows ``[s * gcap, (s + 1) * gcap)``
        of one ``[shards * gcap, F]`` stack (``gcap``: the slot's widest
        shard's column count), gathered on the features' device by one
        ``index_select`` through a flat gather index and copied to the
        slot's device, so its live slots' columns are offset by ``s *
        gcap``; dead slots keep ``(col 0, val 0.0)``, so the zero sentinel
        still decodes to the plans' ``live_w``;
      * one ``ops.block_ell_spmm`` call over the stack, one launch for each
        global bucket ``(previous bound, bound]`` that holds a block of the
        slot, then one ``index_select`` keeps the real rows in shard order
        (the reference scatters into a dump row instead).

    Each shard of a quantized stack has its own ``(scale, x_min)``, so no
    one uint8 gather serves the stack: a pass dequantizes the uint8 stack
    into a float32 one in one ``ops.dequantize`` call (Eq. 2 rounded
    twice, as the uint8 gather rounds), shard ``s``'s rows through entry
    ``s`` of ``[num_shards]`` tables of the shards' constants, then makes
    the float launches.  The uint8 stack is what stays resident.
    """

    def __init__(self, shards, plans, features, device, bounds, quant):
        br = plans[0].bell.block_rows
        self.device = device
        plans = [_plan_to(p, device) for p in plans]
        num = len(shards)
        self.num_shards = num
        self.gcap = gcap = max(s.csr.num_cols for s in shards)
        if num * gcap >= 2 ** 31:
            raise ValueError(f"the stacked operand's {num} x {gcap} rows "
                             "overflow the kernel's int32 columns")

        gidx = np.zeros(num * gcap, np.int64)
        for s, sh in enumerate(shards):
            gidx[s * gcap:s * gcap + len(sh.gather_index)] = sh.gather_index
        # on the features' device, where dense requests arrive too
        self._gidx = torch.from_numpy(gidx).to(features.device)

        self.bell = _stack_block_ells([p.bell for p in plans], gcap)
        blk_off = np.cumsum([0] + [p.bell.num_blocks for p in plans])
        keep = np.concatenate([blk_off[s] * br + np.arange(sh.num_rows)
                               for s, sh in enumerate(shards)])
        # None when the stacked rows are the real rows already
        self._keep = None if keep.size == self.bell.num_rows else \
            torch.from_numpy(keep).to(device)
        self.buckets = buckets_within(self.bell.widths, bounds)

        # Resident operand for x=None requests: the quantized stack, or the
        # float gather copied to the slot's device.
        self._quant = quant
        if quant:
            qs = [p.quantized for p in plans]
            self._resident = qs[0].q.new_zeros((num * gcap,
                                                qs[0].q.shape[1]))
            for s, q in enumerate(qs):
                self._resident[s * gcap:s * gcap + q.q.shape[0]] = q.q
            self._scale = torch.cat([q.scale.reshape(1) for q in qs])
            self._x_min = torch.cat([q.x_min.reshape(1) for q in qs])
            self._bits = qs[0].bits
        else:
            self._resident = features.index_select(0, self._gidx).to(device)
        from repro_torch.kernels import ops

        ops.prepare_block_ell(self.bell, self.buckets)

    def run(self, x=None) -> torch.Tensor:
        """One pass over the slot's shards: ``x=None`` serves the resident
        (possibly uint8) stack; a dense ``[num_nodes, F]`` matrix is
        gathered where it lies and only the stack copied to the slot's
        device.  Returns the slot's rows ``[rows, F]`` on its device."""
        from repro_torch.kernels import ops

        if x is not None:
            stack = x.index_select(0, self._gidx).to(self.device)
        elif self._quant:
            stack = ops.dequantize(self._resident, self._scale, self._x_min,
                                   bits=self._bits)
        else:
            stack = self._resident
        out = ops.block_ell_spmm(self.bell, stack, buckets=self.buckets)
        return out if self._keep is None else out.index_select(0, self._keep)


class GNNServer:
    """Sharded, batched GNN inference engine over per-shard plans.

    Args:
      csr: the adjacency (e.g. ``dataset.gcn_adj``).
      features: the graph's dense node-feature matrix ``[num_nodes, F]``
        — tuned against, optionally pre-quantized into the per-shard
        plans, and served by ``submit(x=None)`` requests.
      num_shards: row shards (default: one per device of the server's
        device type — 1 on a one-card machine).
      mode: ``"loop"`` (per-shard launches) or ``"spmd"`` (the shards
        stacked on each device slot, one launch per non-empty global width
        bucket a slot; a degree-sorted plan raises ``ValueError``).
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
        CPU through the kernels' plain versions.  In ``"spmd"`` mode each
        entry is one slot (repeats allowed: ``["cpu"] * 4`` is four
        stacked passes on the CPU), the shards split over the slots in
        shard order (default: one slot on the first device; the shards
        spread over cards only where the list names several);
        more slots than shards, or a slot neither ``cpu`` nor ``cuda``,
        raises ``ValueError``.
      max_buckets: the most width buckets, so kernel launches, of an
        ``"spmd"`` slot's pass.

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
                 devices=None,
                 max_buckets: int = 3):
        if mode not in ("loop", "spmd"):
            raise ValueError(f"unknown mode {mode!r} "
                             "(expected 'loop' or 'spmd')")
        self.device = shard_devices(1, devices)[0]
        if num_shards is None:
            same_kind = torch.cuda.device_count() \
                if self.device.type == "cuda" else 1
            num_shards = min(same_kind, csr.num_rows)
        self.mode = mode
        self.num_shards = int(num_shards)
        self._mesh = None
        if mode == "spmd":   # before tuning: a bad slot raises here
            self._mesh = serving_mesh(self.num_shards, devices)
            self.device = self._mesh.device
        self.cache = cache if cache is not None else default_cache()
        self.features = torch.as_tensor(features, dtype=torch.float32,
                                        device=self.device)
        self.shards = partition_csr(csr.to(self.device), self.num_shards)
        self.mesh_shape = (self.num_shards,)
        self._quant = quant
        self._tune_kwargs = dict(tune_kwargs or {})
        self._requested_devices = devices
        self._max_buckets = max_buckets
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
        request copies nothing from the host.  In ``"spmd"`` mode
        :func:`_spmd_slots` makes the same check over every shard, and each
        slot's stack is warmed when built.
        """
        from repro_torch.tuning.plan_cache import features_fingerprint

        self._bundles = None
        if self._mesh is not None:
            self._bundles = _spmd_slots(self.shards, self.plans,
                                        self.features, self._mesh,
                                        self._max_buckets)
            # each shard's slot device (the runtime makes a stream a card)
            self._devices = [d for d, (lo, hi) in
                             zip(self._mesh.devices, self._mesh.groups)
                             for _ in range(lo, hi)]
            for s in self.shards:
                s.index_on(self.device)
            return
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
        every other shard's plan is untouched, and the execution state
        (resident operands, or the spmd slots) is rebuilt from the
        swapped-in shards/plans.  Pending submitted
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
        on ``self.device``, whose work is enqueued on the current CUDA
        stream of each card the server uses; an spmd slot's output reaches
        ``self.device`` by a copy ordered after the slot's pass, so the
        values are ready once ``self.device``'s current stream is (callers
        synchronize that stream, or record an event on it and wait for
        the event).

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
        if self._bundles is not None:
            outs = [b.run(x) for b in self._bundles]
            return outs[0] if len(outs) == 1 else \
                concat_shard_outputs(outs, self.device)
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
