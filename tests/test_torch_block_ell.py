"""The port's BlockELL slice against the JAX package's: the containers, the
stitcher, the width buckets, the degree-sorted permutation and the CSR
digests bit for bit; the blocked kernel wrapper (its plain version on CPU
tensors) and ``PlanExecutor.run_block``/``run_plan`` to the reference's
tolerances (1e-5 against the oracle on the same operand, ``scale/2`` plus
that on the quantized path); and the port's plan cache (disk round trip of
both plan kinds, isolation from the reference package's entries, the LRU
bound).  Cases loop inside tests, so the file stays smaller than the JAX
package's test files (see tests/test_torch_core.py)."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core.graph as jg
from repro import obs as jobs
from repro.core.quantization import quantize as jquantize
from repro.core.sampling import sample_csr_to_block_ell as jstitch
from repro.exec import PlanExecutor as JPlanExecutor
from repro.kernels import ref as jref
from repro.tuning import PlanCache as JPlanCache
from repro.tuning import tune as jtune
from repro.tuning import tune_blocked as jtune_blocked
from repro.tuning.cost_model import MachineModel as JMachineModel
import repro_torch.core.graph as tg
from repro_torch import obs
from repro_torch.core.quantization import quantize
from repro_torch.core.sampling import sample_csr_to_block_ell
from repro_torch.exec import PlanExecutor
from repro_torch.kernels import block_ell_spmm as block_mod
from repro_torch.kernels import ops, ref
from repro_torch.tuning import (PLAN_SCHEMA_VERSION, BlockedPlan, MachineModel,
                                PlanCache, TunedPlan, tune, tune_blocked)

from conftest import random_csr

# one intra-op thread: the suite runs in parallel workers beside timing tests
torch.set_num_threads(1)

CPU = "cpu"
CONFIGS = (("aes", 8), ("sfs", 4), ("afs", 16), ("full", 0), ("aes", 32))


def to_port(g) -> tg.CSR:
    return tg.CSR(*(torch.from_numpy(np.array(a)) for a in
                    (g.row_ptr, g.col_ind, g.val)), g.num_cols)


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _same_bell(got, want):
    for field in ("val", "col", "live_w"):
        _same(getattr(got, field), getattr(want, field))
    for field in ("widths", "strategies", "block_rows", "num_rows",
                  "num_cols"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.slot_offsets() == want.slot_offsets()
    assert got.live_edges() == want.live_edges()


def _graphs():
    """Graphs for the stitcher: the block-size sweep of
    tests/test_block_ell.py, the empty graph, and a graph with a hub row
    far above every width (a "full" block thousands of slots wide)."""
    out = []
    for num_rows, block_rows in ((48, 1), (300, 256), (300, 4096),
                                 (300, 301)):
        g = random_csr(np.random.default_rng(num_rows * 31 + block_rows),
                       num_rows, 5.0, skew=0.8)
        out.append((f"n{num_rows}_b{block_rows}", g, block_rows))
    out.append(("empty", jg.csr_from_edges(np.zeros(0, np.int64),
                                           np.zeros(0, np.int64), 24), 8))
    rng = np.random.default_rng(7)
    dst = np.concatenate([np.repeat(np.arange(90), 3), np.full(1500, 45)])
    hub = jg.csr_from_edges(rng.integers(0, 90, dst.shape[0]), dst, 90,
                            rng.normal(size=dst.shape[0]).astype(np.float32))
    out.append(("hub", hub, 16))
    return out


def _configs(num_blocks):
    return [CONFIGS[b % len(CONFIGS)] for b in range(num_blocks)]


def test_containers_match_reference_bit_for_bit():
    """The stitched BlockELL (all-"full" and mixed strategies), the width
    buckets, the degree-sorted permutation and the digests, per graph."""
    for name, g, block_rows in _graphs():
        p = to_port(g)
        nb = max(-(-g.num_rows // block_rows), 1)
        for configs in ([("full", 0)] * nb, _configs(nb)):
            want = jstitch(g, configs, block_rows)
            got = sample_csr_to_block_ell(p, configs, block_rows)
            _same_bell(got, want)
            assert got.val.shape[0] >= got.total_slots + got.max_width
            assert not got.val[got.total_slots:].any()
            for k in (1, 2, 3, 4):
                assert tg.partition_width_buckets(got.widths, k) == \
                    jg.partition_width_buckets(want.widths, k), (name, k)
            if configs[0] == ("full", 0):
                assert got.live_edges() == g.nnz, name   # drops nothing

        jperm, jinv, jsorted = jg.degree_sort_permutation(g)
        perm, inv, psorted = tg.degree_sort_permutation(p)
        _same(perm, jperm)
        _same(inv, jinv)
        for field in ("row_ptr", "col_ind", "val"):
            _same(getattr(psorted, field), getattr(jsorted, field))
        assert tg.csr_block_digests(p, 64) == jg.csr_block_digests(g, 64)
        digests = tg.csr_block_digests(p)
        assert digests == jg.csr_block_digests(g)
        assert tg.combine_block_digests(digests, p.num_rows, p.num_cols) == \
            jg.combine_block_digests(digests, g.num_rows, g.num_cols)
    hub = sample_csr_to_block_ell(to_port(_graphs()[-1][1]), [("full", 0)] * 6,
                                  16)
    assert max(hub.widths) > 1024


def test_blocked_spmm_matches_reference_oracles():
    """``ops.block_ell_spmm`` (the plain version on CPU tensors) against
    the JAX package's oracles, f32 (1e-5) and uint8/uint16 (scale/2 +
    1e-5), over the default, single-bucket and per-block partitions; a
    partial partition leaves the other blocks' rows zero."""
    for name, g, block_rows in _graphs():
        nb = max(-(-g.num_rows // block_rows), 1)
        configs = _configs(nb)
        jbell = jstitch(g, configs, block_rows)
        bell = sample_csr_to_block_ell(to_port(g), configs, block_rows)
        x = np.random.default_rng(len(name)).normal(
            size=(g.num_rows, 33)).astype(np.float32)
        xt = torch.from_numpy(x)
        want = np.asarray(jref.block_ell_spmm(jbell, jnp.asarray(x)))
        parts = (None, ((max(bell.widths), tuple(range(nb))),),
                 tuple((w, (b,)) for b, w in enumerate(bell.widths)))
        for buckets in parts:
            got = ops.block_ell_spmm(bell, xt, buckets=buckets)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5, err_msg=name)
        np.testing.assert_allclose(ref.block_ell_spmm(bell, xt).numpy(),
                                   want, rtol=1e-5, atol=1e-5)
        # the launch table the card reads, built once per operand and
        # partition: (block id, slot offset, width) in launch order
        for buckets in parts[1:]:
            ids = tuple(tuple(blocks) for _, blocks in buckets)
            table = block_mod._device_table(bell.val, bell.widths,
                                            block_rows, ids)
            assert block_mod._device_table(bell.val, bell.widths,
                                           block_rows, ids) is table
            offs = bell.slot_offsets()
            assert table.tolist() == [[b, offs[b], bell.widths[b]]
                                      for blocks in ids for b in blocks]
        for bits in (8, 16):
            qf, jqf = quantize(xt, bits), jquantize(jnp.asarray(x), bits)
            _same(qf.q, jqf.q)
            wantq = np.asarray(jref.quant_block_ell_spmm(jbell, jqf))
            got = ops.block_ell_spmm(bell, qf.q,
                                     quantized_meta=(qf.scale, qf.x_min))
            tol = float(qf.scale) / 2 + 1e-5
            np.testing.assert_allclose(got.numpy(), wantq, rtol=0, atol=tol)
            np.testing.assert_allclose(ref.quant_block_ell_spmm(bell, qf)
                                       .numpy(), wantq, rtol=0, atol=tol)
        if nb > 1:
            keep = tuple(range(0, nb, 2))
            got = ops.block_ell_spmm(
                bell, xt, buckets=((max(bell.widths), keep),)).numpy()
            rows = np.zeros(g.num_rows, bool)
            for b in keep:
                rows[b * block_rows:(b + 1) * block_rows] = True
            np.testing.assert_allclose(got[rows], want[rows], rtol=1e-5,
                                       atol=1e-5)
            assert not got[~rows].any(), name
        key = id(bell.val)      # the memo entry goes with the operand
        assert key in block_mod._TABLES
        del bell
        assert key not in block_mod._TABLES


def test_run_block_and_run_plan_match_reference():
    """``run_block`` f32/int8 on both backends, and ``run_plan`` of tuned
    blocked and global plans (natural and degree-sorted), against the
    JAX package's executor on the same operand; the features-hash guard
    sends any other matrix down the float path, with the reference's
    executor and sampler counters."""
    g = random_csr(np.random.default_rng(19), 150, 7.0, skew=0.7)
    p = to_port(g)
    x = np.random.default_rng(20).normal(size=(150, 12)).astype(np.float32)
    xt, jx = torch.from_numpy(x), jnp.asarray(x)
    configs = _configs(3)
    jbell, bell = jstitch(g, configs, 64), sample_csr_to_block_ell(
        p, configs, 64)
    jqf, qf = jquantize(jx, 8), quantize(xt, 8)
    for q, jq, tol in ((None, None, 1e-5),
                       (qf, jqf, float(qf.scale) / 2 + 1e-5)):
        want = np.asarray(JPlanExecutor().run_block(jbell, jx, backend="jax",
                                                    quantized=jq))
        for backend in ("torch", "cuda"):
            got = PlanExecutor().run_block(bell, xt, backend=backend,
                                           quantized=q)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=tol)

    kw = dict(block_rows=64, widths=(4, 16), machine=JMachineModel(),
              measure_plan=False)
    hidden = np.random.default_rng(21).normal(size=(150, 12)).astype(
        np.float32)
    for layout in ("natural", "degree_sorted"):
        for quant in (None, 8):
            jplan = jtune_blocked(g, jx, cache=JPlanCache(), backend="jax",
                                  layout=layout, quant=quant, **kw)
            plan = tune_blocked(p, xt, cache=PlanCache(), backend="torch",
                                layout=layout, quant=quant,
                                **dict(kw, machine=MachineModel()))
            assert plan.features_fp == jplan.features_fp
            tol = 1e-5 if quant is None else float(plan.quantized.scale) / 2
            outs, counters = [], []
            for pkg, run in ((jobs, lambda f: np.asarray(
                    JPlanExecutor().run_plan(jplan, jnp.asarray(f)))),
                             (obs, lambda f: PlanExecutor().run_plan(
                                 plan, torch.from_numpy(f)).numpy())):
                prev = pkg.set_enabled(True)
                pkg.reset()
                try:
                    outs.append([run(f) for f in (x, hidden)])
                    counters.append({
                        k.replace(".jax.", ".torch."): v for k, v in
                        pkg.default_registry().counters("executor.").items()})
                finally:
                    pkg.reset()
                    pkg.set_enabled(prev)
            for want, got in zip(*outs):
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           atol=tol + 1e-5)
            assert counters[0] == counters[1], counters
            # the hidden matrix misses the guard: exactly the float path
            np.testing.assert_array_equal(
                plan.run(torch.from_numpy(hidden)).numpy(),
                PlanExecutor().run_block(plan.bell, torch.from_numpy(hidden),
                                         inv_perm=plan.inv_perm()).numpy())
    jplan = jtune(g, jx, cache=JPlanCache(), budget=1, widths=(8, 16),
                  machine=JMachineModel(), warmup=0, iters=1)
    plan = tune(p, xt, cache=PlanCache(), budget=1, widths=(8, 16),
                machine=MachineModel(), warmup=0, iters=1)
    np.testing.assert_allclose(PlanExecutor().run_plan(plan, xt).numpy(),
                               np.asarray(JPlanExecutor().run_plan(jplan, jx)),
                               rtol=1e-5, atol=1e-5)


def test_plan_cache_disk_isolation_and_lru(tmp_path, monkeypatch):
    """Both plan kinds survive the port's disk tier; a JAX entry in the
    same directory is a miss for the port and the reverse; a wrong stamp
    is a miss; the disk GC and ``clear(disk=True)`` leave the JAX entry;
    the memory tier keeps ``max_plans`` most recent plans."""
    g = random_csr(np.random.default_rng(23), 60, 5.0, skew=0.8)
    p = to_port(g)
    x = np.random.default_rng(24).normal(size=(60, 8)).astype(np.float32)
    xt = torch.from_numpy(x)
    quick = dict(warmup=0, iters=1)
    cache = PlanCache(cache_dir=tmp_path)
    gplan = tune(p, xt, cache=cache, budget=1, widths=(8,), **quick)
    bplan = tune_blocked(p, xt, cache=cache, block_rows=16, widths=(4, 8),
                         quant=8, layout="degree_sorted", **quick)
    assert isinstance(gplan, TunedPlan) and isinstance(bplan, BlockedPlan)
    assert not list(tmp_path.glob("*.npz"))          # all under repro_torch/

    fresh = PlanCache(cache_dir=tmp_path)
    got = fresh.get(gplan.fingerprint, device=CPU)
    got_b = fresh.get(bplan.fingerprint, kind="block",
                      layout="degree_sorted", device=CPU)
    assert fresh.stats.disk_hits == 2 and gplan.fingerprint in fresh
    assert got.config == gplan.config
    _same(got.ell.val, gplan.ell.val.numpy())
    _same_bell(got_b.bell, bplan.bell)
    _same(got_b.quantized.q, bplan.quantized.q.numpy())
    _same(got_b.perm, bplan.perm)
    assert got_b.buckets == bplan.buckets
    assert got_b.features_fp == bplan.features_fp
    np.testing.assert_array_equal(got_b.run(xt).numpy(),
                                  bplan.run(xt).numpy())

    # a JAX plan for the same graph in the same directory: each package
    # misses the other's entry
    jcache = JPlanCache(cache_dir=tmp_path)
    jplan = jtune(g, jnp.asarray(x), cache=jcache, budget=1, widths=(8,),
                  **quick)
    assert jplan.fingerprint == gplan.fingerprint
    other = PlanCache(cache_dir=tmp_path / "elsewhere")
    other.entry_dir.mkdir(parents=True)
    (other.entry_dir / f"{gplan.fingerprint}.npz").write_bytes(
        (tmp_path / f"{jplan.fingerprint}.npz").read_bytes())
    assert other.get(gplan.fingerprint, device=CPU) is None
    assert gplan.fingerprint not in other
    assert JPlanCache(cache_dir=tmp_path).get(
        bplan.fingerprint, kind="block", layout="degree_sorted") is None

    path = cache._path(gplan.fingerprint)
    with np.load(path) as z:
        arrays = dict(z)
    meta = json.loads(bytes(arrays["meta"].tobytes()).decode())
    assert meta["schema"] == PLAN_SCHEMA_VERSION
    for stamp in (6, None):
        meta["schema"] = stamp
        arrays["meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        np.savez(path, **arrays)
        assert PlanCache(cache_dir=tmp_path).get(gplan.fingerprint,
                                                 device=CPU) is None

    # the disk GC and clear(disk=True) collect only the port's entries
    jfile = tmp_path / f"{jplan.fingerprint}.npz"
    PlanCache(cache_dir=tmp_path, max_disk_plans=1).put(bplan)
    assert len(list(cache.entry_dir.glob("*.npz"))) == 1 and jfile.exists()
    PlanCache(cache_dir=tmp_path).clear(disk=True)
    assert not list(cache.entry_dir.glob("*.npz")) and jfile.exists()

    lru = PlanCache(max_plans=3)
    for i in range(5):
        lru.put(TunedPlan(config=gplan.config, ell=gplan.ell, quantized=None,
                          fingerprint=f"fp{i}"))
    assert len(lru) == 3
    assert lru.get("fp0") is None and lru.get("fp1") is None
    assert lru.get("fp2") is not None          # refreshes fp2's recency
    lru.put(TunedPlan(config=gplan.config, ell=gplan.ell, quantized=None,
                      fingerprint="fp5"))
    assert lru.get("fp2") is not None and lru.get("fp3") is None
    monkeypatch.setenv("REPRO_PLAN_CACHE_MAX", "7")
    assert PlanCache().max_plans == 7
    with pytest.raises(ValueError, match="granularity"):
        from repro_torch.core.aes_spmm import aes_spmm

        aes_spmm(p, xt, strategy="aes", granularity="block")
