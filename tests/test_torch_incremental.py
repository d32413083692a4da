"""The port's incremental plan maintenance against the JAX package's:
``apply_csr_deltas`` (the merged CSR and its touched rows bit for bit, on
the presorted merge and on the unsorted ``lexsort`` path, with duplicate
edges, empty deltas and every ``ValueError``), the rolling digests,
``permute_csr_rows``, ``requantize_rows`` (``q`` bit for bit), and
``apply_edge_updates``: the patched plan equals the reference's patched
plan and the port's cold ``tune_blocked`` of the patched graph (natural,
int8 with ``requant_rows``, int8 past the drift threshold, degree-sorted
against the dense product), its guards, the no-op, a patch stream, the
disk round trip, and a read-only replay of ``tests/corpus/delta-*.json``.

Every tune uses ``machine=MachineModel()``, each package's own fresh
``PlanCache()`` and ``measure_plan=False, measure_buckets=False`` (the
process-wide cache's key ignores the tuning arguments; a patch keeps the
bucket partition a measured tune picked).  Cases loop or are parameters
of a few tests, so the file stays smaller than the JAX package's test
files (see tests/test_torch_core.py).
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core.graph as jg
from repro.core import quantization as jq
from repro.tuning import PlanCache as JPlanCache
from repro.tuning import cost_model as jcost
from repro.tuning import tune_blocked as jtune_blocked
from repro.tuning.incremental import apply_edge_updates as japply
from repro_torch import obs
import repro_torch.core.graph as tg
from repro_torch.core import apply_csr_deltas, requantize_rows
from repro_torch.core import quantization as tq
from repro_torch.tuning import (DeltaReport, MachineModel, PlanCache,
                                apply_edge_updates, tune, tune_blocked)

from conftest import random_csr

# one intra-op thread: the suite runs in parallel workers beside timing tests
torch.set_num_threads(1)

CORPUS_DIR = Path(__file__).parent / "corpus"
TK = dict(block_rows=32, widths=(4, 8), measure_plan=False,
          measure_buckets=False)


def to_port(g) -> tg.CSR:
    return tg.CSR(*(torch.from_numpy(np.array(a)) for a in
                    (g.row_ptr, g.col_ind, g.val)), g.num_cols)


def _same(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert got.tobytes() == want.tobytes(), what


def _same_csr(got, want, what=""):
    assert got.num_cols == want.num_cols, what
    for field in ("row_ptr", "col_ind", "val"):
        _same(getattr(got, field), getattr(want, field), f"{what} {field}")


def _pairs(g) -> np.ndarray:
    """Sorted unique (row, col) pairs of a CSR, as an [E, 2] array."""
    rp, ci = np.asarray(g.row_ptr), np.asarray(g.col_ind)
    rows = np.repeat(np.arange(g.num_rows), np.diff(rp))
    keys = np.unique(rows.astype(np.int64) * g.num_cols + ci)
    return np.stack([keys // g.num_cols, keys % g.num_cols], 1)


def _dedup(g):
    """Duplicate-free, column-sorted copy (the first value of a pair)."""
    rp, ci, v = (np.asarray(a) for a in (g.row_ptr, g.col_ind, g.val))
    rows = np.repeat(np.arange(g.num_rows), np.diff(rp))
    _, first = np.unique(rows.astype(np.int64) * g.num_cols + ci,
                         return_index=True)
    return jg.csr_from_edges(ci[first], rows[first], g.num_rows, v[first])


def _delta(g, rng, n_del, n_add, rows=None, vals=False):
    """``n_del`` present pairs to delete and ``n_add`` absent pairs to
    add (rows drawn from ``rows`` when given), as tuple lists."""
    pairs = _pairs(g)
    if rows is not None:
        pairs = pairs[np.isin(pairs[:, 0], rows)]
    dels = pairs[rng.choice(len(pairs), min(n_del, len(pairs)),
                            replace=False)] if len(pairs) else pairs
    present = set(map(tuple, _pairs(g).tolist()))
    adds = []
    pool = np.arange(g.num_rows) if rows is None else np.asarray(rows)
    for _ in range(50 * n_add):
        if len(adds) == n_add or g.num_cols == 0:
            break
        p = (int(rng.choice(pool)), int(rng.integers(0, g.num_cols)))
        if p not in present:
            present.add(p)
            adds.append(p + (float(rng.normal()),) if vals else p)
    return adds, [tuple(p) for p in dels.tolist()]


def _unsorted(rng):
    """A CSR whose rows are shuffled (not column-sorted), duplicates kept."""
    g = random_csr(rng, 40, 4.0)
    rp, ci, v = (np.asarray(a).copy() for a in (g.row_ptr, g.col_ind,
                                                g.val))
    for r in range(g.num_rows):
        p = rp[r] + rng.permutation(rp[r + 1] - rp[r])
        ci[rp[r]:rp[r + 1]], v[rp[r]:rp[r + 1]] = ci[p], v[p]
    return jg.CSR(jnp.asarray(rp), jnp.asarray(ci), jnp.asarray(v),
                  num_cols=g.num_cols)


# ---------------------------------------------------------------------------
# apply_csr_deltas, permute_csr_rows, digests, requantize_rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["sorted", "unsorted", "duplicates",
                                  "empty_rows"])
def test_apply_csr_deltas_bit_identical(case):
    """Twenty random deltas a case, each on both packages: the same
    ``row_ptr``/``col_ind``/``val`` bytes and the same touched rows."""
    rng = np.random.default_rng(["sorted", "unsorted", "duplicates",
                                 "empty_rows"].index(case))
    for trial in range(20):
        if case == "sorted":
            g = _dedup(random_csr(rng, int(rng.integers(2, 70)),
                                  float(rng.uniform(0.5, 6.0))))
        elif case == "unsorted":
            g = _unsorted(rng)
        elif case == "duplicates":     # pairs stored twice, sorted rows
            g = random_csr(rng, 30, 6.0, skew=0.7)
        else:                          # rows emptied and refilled
            g = _dedup(random_csr(rng, 24, 1.0))
        rows = None if case != "empty_rows" else rng.choice(24, 3)
        adds, dels = _delta(g, rng, int(rng.integers(0, 8)),
                            int(rng.integers(0, 8)), rows=rows,
                            vals=bool(trial % 2))
        want, wt = jg.apply_csr_deltas(g, adds, dels)
        got, gt = apply_csr_deltas(to_port(g), adds, dels)
        _same_csr(got, want, f"{case} {trial}")
        assert gt.dtype == np.int64 and gt.tolist() == wt.tolist()
    if case == "unsorted":             # tests/test_incremental.py's case
        g = jg.CSR(jnp.asarray(np.array([0, 3, 3, 5], np.int32)),
                   jnp.asarray(np.array([2, 0, 1, 2, 1], np.int32)),
                   jnp.asarray(np.arange(5, dtype=np.float32) + 1),
                   num_cols=3)
        got, gt = apply_csr_deltas(to_port(g), [(1, 0)], [(0, 2)])
        _same_csr(got, jg.apply_csr_deltas(g, [(1, 0)], [(0, 2)])[0])
        assert gt.tolist() == [0, 1]
    if case == "duplicates":           # every stored instance goes
        g = jg.csr_from_edges(np.array([3, 3, 5]), np.array([1, 1, 1]), 8)
        got, _ = apply_csr_deltas(to_port(g), (), [(1, 3)])
        assert got.col_ind.tolist() == [5] and got.row_ptr[2] == 1


def test_apply_csr_deltas_errors_and_empty_delta():
    rng = np.random.default_rng(12)
    g = _dedup(random_csr(rng, 12, 3.0))
    p = to_port(g)
    present = _pairs(g)
    r0, c0 = present[0].tolist()
    have = set(map(tuple, present.tolist()))
    absent = next((r, c) for r in range(12) for c in range(12)
                  if (r, c) not in have)
    cases = [([(0, 99)], ()), ((), [(99, 0)]), ([(-1, 0)], ()),
             ((), [absent]), ([(r0, c0)], ()), ([absent, absent], ()),
             ((), [(r0, c0), (r0, c0)]), ([(1,)], ()), ([(1.5, 2)], ()),
             ([(r0, c0)], [absent])]
    for adds, dels in cases:
        with pytest.raises(ValueError) as want:
            jg.apply_csr_deltas(g, adds, dels)
        with pytest.raises(ValueError) as got:
            apply_csr_deltas(p, adds, dels)
        assert str(got.value) == str(want.value), (adds, dels)
    out, touched = apply_csr_deltas(p)
    assert out is p and touched.dtype == np.int64 and touched.size == 0
    # deleting then re-adding a pair in one delta is legal
    out, _ = apply_csr_deltas(p, [(r0, c0, 7.0)], [(r0, c0)])
    _same_csr(out, jg.apply_csr_deltas(g, [(r0, c0, 7.0)], [(r0, c0)])[0])


def test_digests_and_row_permutation_after_patches():
    """Rolled digests (only touched digest blocks re-hashed) equal a full
    re-hash and the reference's digests after each patch; permuting the
    patched CSR's rows gives the reference's bytes."""
    rng = np.random.default_rng(4)
    g = _dedup(random_csr(rng, 200, 4.0))
    cur, jcur = to_port(g), g
    digests = tg.csr_block_digests(cur, digest_rows=64)
    assert digests == jg.csr_block_digests(g, digest_rows=64)
    for step in range(4):
        adds, dels = _delta(jcur, rng, 3, 4)
        jcur, _ = jg.apply_csr_deltas(jcur, adds, dels)
        cur, touched = apply_csr_deltas(cur, adds, dels)
        for b in np.unique(touched // 64):
            digests[int(b)] = tg.csr_block_digests(
                cur, digest_rows=64, blocks=[int(b)])[0]
        full = jg.csr_block_digests(jcur, digest_rows=64)
        assert digests == full == tg.csr_block_digests(
            tg.CSR(*(t.clone() for t in cur[:3]), cur.num_cols),
            digest_rows=64), step
        assert tg.csr_block_digests(cur, blocks=[0]) == \
            jg.csr_block_digests(jcur, blocks=[0])
        perm = rng.permutation(200)
        _same_csr(tg.permute_csr_rows(cur, perm),
                  jg.permute_csr_rows(jcur, perm), f"perm {step}")


@pytest.mark.parametrize("bits", [8, 16])
def test_requantize_rows_bit_identical(bits):
    rng = np.random.default_rng(bits)
    x = (rng.normal(size=(90, 13)) * 2).astype(np.float32)
    jqf, tqf = jq.quantize(x, bits), tq.quantize(torch.from_numpy(x), bits)
    for rows in ([], [3], [0, 5, 89, 40], list(range(0, 90, 7))):
        vals = (rng.normal(size=(len(rows), 13)) * 3).astype(np.float32)
        want = jq.requantize_rows(jqf, rows, vals)
        got = requantize_rows(tqf, rows, torch.from_numpy(vals))
        _same(got.q, want.q, str(rows))
        if not rows:
            assert got is tqf
        assert float(got.x_min) == float(want.x_min)
    assert torch.equal(tqf.q, tq.quantize(torch.from_numpy(x), bits).q)


# ---------------------------------------------------------------------------
# apply_edge_updates
# ---------------------------------------------------------------------------

def _plans(g, x, **kw):
    """The reference's and the port's plan for one graph, fresh caches."""
    jplan = jtune_blocked(g, jnp.asarray(x), cache=JPlanCache(),
                          backend="jax", machine=jcost.MachineModel(),
                          **TK, **kw)
    plan = tune_blocked(to_port(g), torch.from_numpy(x), cache=PlanCache(),
                        backend="torch", machine=MachineModel(), **TK, **kw)
    return jplan, plan


def _plan_parity(got, want, what=""):
    """The fields tests/test_incremental.py holds a patch to, bit for bit."""
    assert got.fingerprint == want.fingerprint, what
    assert got.block_digests == want.block_digests, what
    assert got.bell.widths == want.bell.widths, what
    assert got.bell.strategies == want.bell.strategies, what
    assert got.buckets == want.buckets, what
    for field in ("val", "col", "live_w"):
        _same(getattr(got.bell, field), getattr(want.bell, field),
              f"{what} {field}")
    assert got.features_fp == want.features_fp, what
    if want.quantized is None:
        assert got.quantized is None, what
    else:
        _same(got.quantized.q, want.quantized.q, f"{what} q")
        assert float(got.quantized.x_min) == float(want.quantized.x_min)
        assert float(got.quantized.x_max) == float(want.quantized.x_max)


@pytest.mark.parametrize("kind", ["natural", "int8", "int8_drift",
                                  "degree_sorted"])
def test_patched_plan_matches_reference_and_cold_tune(kind):
    rng = np.random.default_rng(7)
    g = _dedup(random_csr(rng, 300, 5.0))
    x = rng.normal(size=(300, 8)).astype(np.float32)
    kw = {"natural": {}, "int8": {"quant": 8}, "int8_drift": {"quant": 8},
          "degree_sorted": {"layout": "degree_sorted"}}[kind]
    jplan, plan = _plans(g, x, **kw)
    adds, dels = _delta(g, rng, 10, 7)
    x2, requant = x, ()
    if kind.startswith("int8"):
        # rows that hold neither extreme; halved, they stay in range, and
        # tripled they move the range past the drift threshold
        extreme = {int(np.argmax(x.max(1))), int(np.argmin(x.min(1)))}
        requant = [r for r in (3, 7, 11, 13, 17, 19) if r not in extreme][:4]
        x2 = x.copy()
        x2[requant] *= 0.5 if kind == "int8" else 3.0
    cache = PlanCache()
    patched, new, report = apply_edge_updates(
        plan, to_port(g), adds, dels, widths=TK["widths"],
        features=torch.from_numpy(x2), requant_rows=requant,
        machine=MachineModel(), cache=cache)
    jpatched, jnew, jreport = japply(
        jplan, g, adds, dels, widths=TK["widths"], features=jnp.asarray(x2),
        requant_rows=requant, machine=jcost.MachineModel())
    _same_csr(new, jnew, kind)
    _plan_parity(patched, jpatched, kind)
    assert dataclasses.asdict(report) == dataclasses.asdict(jreport)
    assert isinstance(report, DeltaReport) and report.blocks_skipped > 0
    assert report.requant_refreshed == (kind == "int8_drift")
    assert patched.version == 1 and patched.measured_spmm_us == 0.0
    assert patched.quant_drift == jpatched.quant_drift
    if patched.perm is not None:
        _same(patched.perm, jpatched.perm)
    np.testing.assert_allclose(patched.run(torch.from_numpy(x2)).numpy(),
                               np.asarray(jpatched.run(jnp.asarray(x2))),
                               rtol=1e-5, atol=1e-5, err_msg=kind)
    assert cache.get(patched.fingerprint, "block",
                     layout=patched.layout) is patched

    cold = tune_blocked(new, torch.from_numpy(x2), cache=PlanCache(),
                        refresh=True, backend="torch",
                        machine=MachineModel(), **TK, **kw)
    if kind == "degree_sorted":
        # the perm is frozen at tune time: the fingerprint is the natural
        # cold tune's, and the output the patched graph's exact product
        assert patched.fingerprint == cold.fingerprint
        _same(patched.perm, plan.perm)
        want = tg.csr_to_dense(new) @ torch.from_numpy(x2)
        torch.testing.assert_close(patched.run(torch.from_numpy(x2)), want,
                                   rtol=1e-4, atol=1e-4)
    else:
        _plan_parity(patched, cold, kind)
        assert cold.version == 0
        _same(patched.run(torch.from_numpy(x2)),
              cold.run(torch.from_numpy(x2)), kind)


def test_patch_guards_and_noop():
    rng = np.random.default_rng(8)
    g = _dedup(random_csr(rng, 60, 3.0))
    p = to_port(g)
    x = torch.from_numpy(rng.normal(size=(60, 4)).astype(np.float32))
    plan = tune_blocked(p, x, cache=PlanCache(), machine=MachineModel(),
                        **TK)
    other = _dedup(random_csr(np.random.default_rng(99), 60, 3.0))
    dels = [tuple(_pairs(other)[0].tolist())]
    with pytest.raises(ValueError, match="pre-delta"):
        apply_edge_updates(plan, to_port(other), (), dels,
                           widths=TK["widths"], features=x)
    # same fingerprint claimed, another graph: the touched-block guard
    forged = dataclasses.replace(
        plan, block_digests=tuple(tg.csr_block_digests(to_port(other))),
        fingerprint=tg.combine_block_digests(
            tg.csr_block_digests(to_port(other)), 60, 60))
    with pytest.raises(ValueError, match="pre-delta"):
        apply_edge_updates(forged, p, (), [tuple(_pairs(g)[0].tolist())],
                           widths=TK["widths"], features=x)
    with pytest.raises(ValueError, match="does not match"):
        apply_edge_updates(plan, to_port(random_csr(rng, 61, 3.0)), (),
                           dels)
    gplan = tune(p, x, budget=1, warmup=0, iters=1, cache=PlanCache(),
                 machine=MachineModel())
    with pytest.raises(ValueError, match="BlockedPlans only"):
        apply_edge_updates(gplan, p, (), dels, features=x)
    qplan = tune_blocked(p, x, quant=8, cache=PlanCache(),
                         machine=MachineModel(), **TK)
    adds, _ = _delta(g, rng, 0, 1)
    with pytest.raises(ValueError, match="features="):
        apply_edge_updates(qplan, p, adds, ())
    with pytest.raises(ValueError, match="not quantized"):
        apply_edge_updates(plan, p, adds, (), features=x, requant_rows=[1])
    # the no-op returns the plan and the CSR themselves
    obs.reset()
    out, csr_out, report = apply_edge_updates(plan, p, (), (),
                                              widths=TK["widths"],
                                              features=x)
    assert out is plan and csr_out is p
    assert report.version == plan.version and report.touched_blocks == ()
    assert obs.default_registry().counter_value(
        "incremental.noop_patches") == 1
    # a patch counts what it touched, under the reference's names
    obs.reset()
    patched, _, report = apply_edge_updates(plan, p, adds, (),
                                            widths=TK["widths"], features=x)
    counters = obs.default_registry().counters("incremental.")
    assert counters == {
        "incremental.patches": 1,
        "incremental.blocks_touched": len(report.touched_blocks),
        "incremental.blocks_skipped": report.blocks_skipped,
        "incremental.digest_blocks_touched": 1,
        "incremental.requantized_rows": 0}
    assert any(sp.name == "incremental.apply_edge_updates"
               for sp in obs.default_tracer().spans())


def test_patch_stream_matches_reference_and_cold_tune():
    """Three patches in a row on both packages, then a cold tune of the
    final graph; the degree-sorted stream keeps its perm.  The widths
    cover every row of every state, so the output is the exact product."""
    rng = np.random.default_rng(9)
    g = _dedup(random_csr(rng, 256, 4.0))
    x = rng.normal(size=(256, 5)).astype(np.float32)
    chunks, states = [], [g]
    for _ in range(3):
        chunks.append(_delta(states[-1], rng, 8, 8,
                             rows=rng.choice(256, 12, replace=False)))
        states.append(jg.apply_csr_deltas(states[-1], *chunks[-1])[0])
    wmax = max(int(np.diff(np.asarray(s.row_ptr)).max()) for s in states)
    tk = dict(TK, widths=(wmax, 2 * wmax))
    for layout in ("natural", "degree_sorted"):
        jplan = jtune_blocked(g, jnp.asarray(x), cache=JPlanCache(),
                              backend="jax", machine=jcost.MachineModel(),
                              layout=layout, **tk)
        plan = tune_blocked(to_port(g), torch.from_numpy(x),
                            cache=PlanCache(), backend="torch",
                            machine=MachineModel(), layout=layout, **tk)
        jcur, cur = g, to_port(g)
        for step, (adds, dels) in enumerate(chunks):
            jplan, jcur, _ = japply(jplan, jcur, adds, dels,
                                    widths=tk["widths"],
                                    features=jnp.asarray(x),
                                    machine=jcost.MachineModel())
            plan, cur, _ = apply_edge_updates(
                plan, cur, adds, dels, widths=tk["widths"],
                features=torch.from_numpy(x), machine=MachineModel())
            _plan_parity(plan, jplan, f"{layout} {step}")
            assert plan.version == step + 1
        cold = tune_blocked(cur, torch.from_numpy(x), cache=PlanCache(),
                            refresh=True, machine=MachineModel(), **tk)
        assert plan.fingerprint == cold.fingerprint
        if layout == "natural":
            _plan_parity(plan, cold, layout)
        torch.testing.assert_close(
            plan.run(torch.from_numpy(x)),
            tg.csr_to_dense(cur) @ torch.from_numpy(x), rtol=1e-4,
            atol=1e-4)


def test_fresh_cache_instance_sees_patched_entry(tmp_path):
    rng = np.random.default_rng(10)
    g = _dedup(random_csr(rng, 80, 4.0))
    p = to_port(g)
    x = torch.from_numpy(rng.normal(size=(80, 6)).astype(np.float32))
    cache = PlanCache(cache_dir=tmp_path)
    plan = tune_blocked(p, x, cache=cache, machine=MachineModel(), **TK)
    patched, _, _ = apply_edge_updates(
        plan, p, (), [tuple(a) for a in _pairs(g)[:3].tolist()],
        widths=TK["widths"], features=x, machine=MachineModel(),
        cache=cache)
    fresh = PlanCache(cache_dir=tmp_path)
    loaded = fresh.get(patched.fingerprint, "block", device="cpu")
    assert loaded is not None and loaded is not patched
    assert loaded.version == 1
    assert loaded.block_digests == patched.block_digests
    for field in ("val", "col", "live_w"):
        assert torch.equal(getattr(loaded.bell, field),
                           getattr(patched.bell, field))
    assert fresh.get(plan.fingerprint, "block", device="cpu") is not None


def _replay(case: dict) -> None:
    """One delta-stream case on both packages: the same CSR bytes and
    touched rows after each chunk, and rolled digests equal to a full
    re-hash."""
    rng = np.random.default_rng(case["seed"])
    g = _dedup(random_csr(rng, case["num_nodes"], case["avg_deg"]))
    jcur, cur = g, to_port(g)
    digests = tg.csr_block_digests(cur)
    pairs = [tuple(p) for p in case["pairs"]]
    for start in range(0, len(pairs), 6):
        present = set(map(tuple, _pairs(jcur).tolist()))
        adds, dels, seen = [], [], set()
        for r, c in pairs[start:start + 6]:
            pr = (int(r) % jcur.num_rows, int(c) % jcur.num_cols)
            if pr not in seen:
                seen.add(pr)
                (dels if pr in present else adds).append(pr)
        jcur, wt = jg.apply_csr_deltas(jcur, adds, dels)
        cur, gt = apply_csr_deltas(cur, adds, dels)
        _same_csr(cur, jcur, str(case))
        assert gt.tolist() == wt.tolist()
        for b in np.unique(gt // tg.DIGEST_BLOCK_ROWS):
            digests[int(b)] = tg.csr_block_digests(cur, blocks=[int(b)])[0]
        assert tg.combine_block_digests(digests, cur.num_rows,
                                        cur.num_cols) == \
            tg.combine_block_digests(jg.csr_block_digests(jcur),
                                     jcur.num_rows, jcur.num_cols)


def test_corpus_replay_and_seeded_streams():
    """Every ``tests/corpus/delta-*.json`` case (read only: this test
    never writes there), then seeded random streams."""
    assert CORPUS_DIR.is_dir()
    for path in sorted(CORPUS_DIR.glob("delta-*.json")):
        _replay(json.loads(path.read_text()))
    master = np.random.default_rng(20260809)
    for _ in range(12):
        _replay({"seed": int(master.integers(0, 2**31)),
                 "num_nodes": int(master.integers(3, 80)),
                 "avg_deg": float(master.uniform(0.5, 6.0)),
                 "pairs": master.integers(0, 4096, (int(
                     master.integers(0, 24)), 2)).tolist()})
