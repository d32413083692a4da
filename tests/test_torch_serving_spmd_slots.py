"""The port's ``GNNServer(mode="spmd")`` over several device slots: the
shards split in shard order over ``devices=`` (one slot an entry, repeats
allowed), each slot's shards stacked and served by its own
``block_ell_spmm`` pass, the slots' outputs gathered in order.

The reference runs one ``shard_map`` program over one device a shard;
``devices=["cpu"] * k`` is its counterpart on the CPU, as JAX's forced host
devices are.  Held, through the kernels' plain versions, bit for bit
(``torch.equal``) against loop mode and against the one-slot server on the
same plans, for k in {1, 2, 3, 4} slots over 4 shards (f32 and int8,
resident and dense requests, equal and ragged shards); and the layout of
``serving_mesh``, the launches of a pass (at most ``slots x max_buckets``,
one slot exactly as the one-stack pass), the rules that hold across slots
(global width buckets, the all-or-nothing quantized resident operand),
edge updates, and the runtime against ``flush()``.  (The 4-slot server
against the JAX package's spmd on four forced host devices is in
``tests/test_torch_serving_spmd.py``.)

Every tune uses a fresh ``PlanCache()`` and ``measure_plan=False,
measure_buckets=False``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro_torch.core.graph as tg
from repro_torch.core.graph import partition_width_buckets
from repro_torch.distributed import SHARD_AXIS, serving_mesh
from repro_torch.kernels import ops
from repro_torch.serving import (GNNServer, ServingRuntime, partition_csr,
                                 plan_shard)
from repro_torch.serving.engine import _spmd_slots
from repro_torch.tuning import MachineModel, PlanCache

from conftest import random_csr

# one intra-op thread: the suite runs in parallel workers beside timing tests
torch.set_num_threads(1)

CPU = "cpu"
SHARDS = 4
TUNE = dict(measure_plan=False, measure_buckets=False, warmup=0, iters=1,
            block_rows=8, widths=(2, 4, 8))


def to_port(g) -> tg.CSR:
    return tg.CSR(*(torch.from_numpy(np.array(a)) for a in
                    (g.row_ptr, g.col_ind, g.val)), g.num_cols)


def _graph(rows, seed=0, feat=6):
    rng = np.random.default_rng(seed)
    g = to_port(random_csr(rng, rows, 5.0, skew=0.8))
    x = torch.from_numpy(rng.normal(size=(rows, feat)).astype(np.float32))
    h = torch.from_numpy(rng.normal(size=(rows, 3)).astype(np.float32))
    return g, x, h


def _servers(g, x, slots, quant=None, shards=SHARDS):
    """Loop mode, one slot and ``slots`` CPU slots, on the same plans (one
    shared cache)."""
    kw = dict(num_shards=shards, quant=quant, cache=PlanCache(),
              tune_kwargs=dict(TUNE, machine=MachineModel()))
    loop = GNNServer(g, x, devices=[CPU], **kw)
    one = GNNServer(g, x, mode="spmd", devices=[CPU], **kw)
    many = GNNServer(g, x, mode="spmd", devices=[CPU] * slots, **kw)
    return loop, one, many


@pytest.mark.parametrize("rows", [88, 90])        # equal, ragged 23/23/22/22
@pytest.mark.parametrize("slots", [1, 2, 3, 4])
def test_slots_bit_equal_to_loop_mode_and_one_slot(slots, rows):
    g, x, h = _graph(rows, seed=rows + slots)
    for quant in (None, 8):
        loop, one, many = _servers(g, x, slots, quant)
        assert len(many._bundles) == slots
        assert all(b._quant == (quant is not None) for b in many._bundles)
        assert sum(b.num_shards for b in many._bundles) == SHARDS
        for op in (None, h, h * 2.0):
            want = loop.aggregate(op)
            got = many.aggregate(op)
            assert got.shape == want.shape
            assert torch.equal(got, want), (quant, op is None)
            assert torch.equal(got, one.aggregate(op)), (quant, op is None)
        # a micro-batch of a resident and two dense requests
        t = [many.submit(), many.submit(h), many.submit(h * 2.0)]
        out = many.flush()
        assert torch.equal(out[t[0]], loop.aggregate())
        assert torch.equal(out[t[1]], loop.aggregate(h))
        assert torch.equal(out[t[2]], loop.aggregate(h * 2.0))


@pytest.mark.parametrize("shards,slots,groups", [
    (4, 3, ((0, 2), (2, 3), (3, 4))),
    (4, 4, ((0, 1), (1, 2), (2, 3), (3, 4))),
    (7, 3, ((0, 3), (3, 5), (5, 7))),
    (5, 1, ((0, 5),)),
])
def test_serving_mesh_groups(shards, slots, groups):
    mesh = serving_mesh(shards, [CPU] * slots)
    assert (mesh.shape, mesh.axis_names) == ((shards,), (SHARD_AXIS,))
    assert mesh.groups == groups
    assert mesh.devices == (torch.device("cpu"),) * slots
    assert mesh.device == torch.device("cpu")
    # the server's per-shard devices follow the groups
    g, x, _ = _graph(40, seed=shards)
    server = GNNServer(g, x, num_shards=shards, mode="spmd",
                       devices=[CPU] * slots, cache=PlanCache(),
                       tune_kwargs=dict(TUNE, machine=MachineModel()))
    assert server._devices == [torch.device("cpu")] * shards
    assert [b.num_shards for b in server._bundles] == \
        [hi - lo for lo, hi in groups]


def test_serving_mesh_devices(monkeypatch):
    # one device is one slot, whatever the shard count
    for one in (CPU, torch.device("cpu")):
        assert serving_mesh(3, one).groups == ((0, 3),)
    with pytest.raises(ValueError, match="got 5: a slot holds at least"):
        serving_mesh(4, [CPU] * 5)
    with pytest.raises(ValueError, match="slot 0 is a 'meta' device"):
        serving_mesh(2, ["meta"])
    with pytest.raises(ValueError, match="num_shards"):
        serving_mesh(0, CPU)
    # the default: one slot on the current card, however many there are;
    # none raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        serving_mesh(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for cards in (1, 8):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
        mesh = serving_mesh(4)
        assert (mesh.devices, mesh.groups) == ((torch.device("cuda", 0),),
                                              ((0, 4),))
    # several cards only where the caller lists them
    mesh = serving_mesh(3, [f"cuda:{i}" for i in range(3)])
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(3))
    assert mesh.groups == ((0, 1), (1, 2), (2, 3))


@pytest.mark.parametrize("quant", [None, 8])
def test_launches_a_pass(monkeypatch, quant):
    g, x, h = _graph(90, seed=3)
    calls = {"block_ell_spmm": [], "dequantize": 0}
    real_block, real_deq = ops.block_ell_spmm, ops.dequantize

    def block(bell, b, **k):
        calls["block_ell_spmm"].append(k["buckets"])
        return real_block(bell, b, **k)

    def deq(*a, **k):
        calls["dequantize"] += 1
        return real_deq(*a, **k)

    monkeypatch.setattr(ops, "block_ell_spmm", block)
    monkeypatch.setattr(ops, "dequantize", deq)
    for slots in (1, 2, 4):
        _, _, server = _servers(g, x, slots, quant)
        if slots == 1:
            # one slot launches what the one-stack pass launched
            bundle = server._bundles[0]
            assert bundle.buckets == partition_width_buckets(
                bundle.bell.widths, 3)
        for op in (None, h):
            calls["block_ell_spmm"], calls["dequantize"] = [], 0
            server.aggregate(op)
            assert calls["block_ell_spmm"] == [b.buckets
                                               for b in server._bundles]
            launches = sum(len(bk) for bk in calls["block_ell_spmm"])
            assert 1 <= launches <= slots * 3
            assert all(ids for bk in calls["block_ell_spmm"]
                       for _, ids in bk)
            # one dequantize a slot, over its whole uint8 stack
            assert calls["dequantize"] == \
                (slots if quant and op is None else 0)


def test_rules_hold_across_slots():
    g, x, _ = _graph(88, seed=13)
    shards = partition_csr(g, SHARDS)
    tk = dict(TUNE, machine=MachineModel())
    # shards 0-1 quantized, 2-3 not: slot 0 alone would serve uint8
    plans = [plan_shard(s, x, quant=8 if i < 2 else None,
                        mesh_shape=(SHARDS,), cache=PlanCache(),
                        tune_kwargs=tk)
             for i, s in enumerate(shards)]
    slots = _spmd_slots(shards, plans, x, serving_mesh(SHARDS, [CPU] * 2))
    assert [b._quant for b in slots] == [False, False]
    for b, (lo, hi) in zip(slots, ((0, 2), (2, 4))):
        assert b._resident.dtype == torch.float32
        assert torch.equal(b._resident[:len(shards[lo].gather_index)],
                           shards[lo].gather(x))
    quant_only = _spmd_slots(shards[:2], plans[:2], x,
                             serving_mesh(2, [CPU] * 2))
    assert [b._quant for b in quant_only] == [True, True]
    # every slot's buckets fall in the global bounds
    bounds = [w for w, _ in partition_width_buckets(
        [w for p in plans for w in p.bell.widths], 3)]
    for b in slots:
        for width, ids in b.buckets:
            hi = next(bd for bd in bounds if width <= bd)
            lo = max([bd for bd in bounds if bd < hi], default=0)
            assert all(lo < b.bell.widths[i] <= hi for i in ids)
    # and one block_rows across every shard, checked before any slot
    odd = plan_shard(shards[3], x, cache=PlanCache(),
                     tune_kwargs=dict(tk, block_rows=16))
    with pytest.raises(ValueError, match="one block_rows"):
        _spmd_slots(shards, plans[:3] + [odd], x,
                    serving_mesh(SHARDS, [CPU] * 2))


def _delta(g):
    """Replace one edge of a row by a local column it lacks, and give a
    later row an edge to a far column (the first shard's halo grows)."""
    rp, ci = g.row_ptr.numpy(), g.col_ind.numpy()
    row = int(np.flatnonzero(np.diff(rp) >= 2)[0])
    cols = ci[rp[row]:rp[row + 1]]
    new = next(c for c in range(g.num_rows) if c not in cols)
    far = g.num_rows - 1
    return ([(row, int(new), 0.5), (row + 1, far, 2.0)],
            [(row, int(cols[0]))])


@pytest.mark.parametrize("quant", [None, 8])
def test_slots_edge_updates_equal_loop_mode(quant):
    g, x, h = _graph(60, seed=9)
    loop, _, many = _servers(g, x, 2, quant, shards=3)
    adds, dels = _delta(g)
    r_loop = loop.apply_edge_updates(adds, dels)
    r_many = many.apply_edge_updates(adds, dels)
    for key in ("patched", "retuned", "untouched"):
        assert r_loop[key] == r_many[key], key
    assert len(many._bundles) == 2
    for op in (None, h):
        assert torch.equal(many.aggregate(op), loop.aggregate(op))


def test_slots_runtime_results_equal_flush():
    g, x, h = _graph(70, seed=4)
    _, _, server = _servers(g, x, 2)
    t0, t1 = server.submit(), server.submit(h)
    sync = server.flush()
    with ServingRuntime(server, max_batch=3, max_delay_ms=20.0) as rt:
        reqs = [rt.submit(), rt.submit(h)] + [rt.submit() for _ in range(6)]
        assert torch.equal(reqs[0].result(30), sync[t0])
        assert torch.equal(reqs[1].result(30), sync[t1])
        assert all(torch.equal(r.result(30), sync[t0]) for r in reqs[2:])
        snap = rt.snapshot()
    assert snap["counters"]["completed"] == 8
    assert snap["counters"]["batches"] >= 2
