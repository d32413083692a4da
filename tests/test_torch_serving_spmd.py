"""The port's ``GNNServer(mode="spmd")`` on one device slot: every shard
stacked on one device and served by one ``block_ell_spmm`` call a pass
(``tests/test_torch_serving_spmd_slots.py`` holds several slots).

Held on the CPU, through the kernels' plain versions, against
  * the port's loop mode on the same plans, bit for bit (``torch.equal``):
    f32 and int8 plans, resident and dense requests, 1, 2 and 4 shards,
    equal and ragged;
  * the JAX package's spmd mode: in this process at one shard, and in one
    subprocess on four forced host devices over equal shards (88 rows; the
    reference's ragged trim raises ``ShardingTypeError`` on the installed
    jax), against both a one-slot server and one of four CPU slots
    (``devices=["cpu"] * 4``, the counterpart of four devices): f32 and
    int8 within 1e-5, the tolerance of
    ``tests/test_torch_serving.py::test_quantized_server_within_half_scale``
    (the reference dequantizes in XLA before its row loop, 5.7e-6 from its
    own loop mode in int8);
  * the dense ``ref.csr_spmm`` on ragged shards (exact tunes, 1e-5);
and its refusals (a degree-sorted plan, mixed ``block_rows``, a slot that
is neither a CPU nor a card, more slots than shards), one kernel call a
pass, edge updates against loop mode, and the runtime against
``flush()``.

Every tune uses a fresh ``PlanCache()`` and ``measure_plan=False,
measure_buckets=False``.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.serving as js
from repro.distributed.serving import SHARD_AXIS as J_SHARD_AXIS
from repro.kernels import ref as jref
from repro.tuning import PlanCache as JPlanCache
from repro.tuning.cost_model import MachineModel as JMachineModel
import repro_torch.core.graph as tg
from repro_torch.distributed import SHARD_AXIS, serving_mesh
from repro_torch.kernels import ops
from repro_torch.serving import (GNNServer, ServingRuntime, partition_csr,
                                 plan_shard)
from repro_torch.serving.engine import _spmd_slots
from repro_torch.tuning import MachineModel, PlanCache

from conftest import random_csr

# one intra-op thread: the suite runs in parallel workers beside timing tests
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
NO_MEASURE = dict(measure_plan=False, measure_buckets=False, warmup=0,
                  iters=1)


def to_port(g) -> tg.CSR:
    return tg.CSR(*(torch.from_numpy(np.array(a)) for a in
                    (g.row_ptr, g.col_ind, g.val)), g.num_cols)


def _tk(g, port: bool = True, exact: bool = False) -> dict:
    """Tuning knobs: sampled (several widths, so several buckets) or, with
    ``exact``, no candidate truncating an edge."""
    tk = dict(NO_MEASURE, machine=MachineModel() if port
              else JMachineModel())
    if exact:
        tk.update(widths=(max(int(np.asarray(g.row_nnz()).max()), 1),),
                  include_full=True)
    else:
        tk.update(block_rows=8, widths=(2, 4, 8))
    return tk


def _graph(rows, seed=0, feat=6):
    rng = np.random.default_rng(seed)
    g = random_csr(rng, rows, 5.0, skew=0.8)
    x = rng.normal(size=(rows, feat)).astype(np.float32)
    h = rng.normal(size=(rows, 3)).astype(np.float32)
    return g, x, h


def _pair(g, x, shards, quant=None, exact=False, slots=1):
    """Loop and spmd servers on the same plans (one shared cache), the
    spmd one over ``slots`` CPU slots."""
    cache = PlanCache()
    kw = dict(num_shards=shards, quant=quant, cache=cache,
              tune_kwargs=_tk(g, exact=exact))
    loop = GNNServer(to_port(g), torch.from_numpy(x), devices=[CPU], **kw)
    spmd = GNNServer(to_port(g), torch.from_numpy(x), mode="spmd",
                     devices=[CPU] * slots, **kw)
    return loop, spmd


def _dense_ref(g, x):
    return np.asarray(jref.csr_spmm(g.row_ptr, g.col_ind, g.val, x))


@pytest.mark.parametrize("shards,rows", [(1, 37), (2, 48), (2, 49), (4, 88),
                                         (4, 90)])
def test_spmd_bit_equal_to_loop_mode(shards, rows):
    g, x, h = _graph(rows, seed=rows)
    for quant in (None, 8):
        loop, spmd = _pair(g, x, shards, quant)
        assert len(spmd._bundles) == 1
        bundle = spmd._bundles[0]
        assert bundle._quant == (quant is not None)
        assert spmd._mesh.shape == (shards,)
        assert len(bundle.buckets) <= 3
        # the stacked live widths decode from the zero sentinel as stored
        bell = bundle.bell
        br = bell.block_rows
        assert all(torch.equal(tg.ell_live_widths(*bell.block_segment(i)),
                               bell.live_w[i * br:(i + 1) * br])
                   for i in range(bell.num_blocks))
        for op in (None, torch.from_numpy(h)):
            want, got = loop.aggregate(op), spmd.aggregate(op)
            assert got.shape == want.shape == (rows, x.shape[1] if op is None
                                               else h.shape[1])
            assert torch.equal(got, want), (quant, op is None)
        # a micro-batch of a resident and two dense requests
        t = [spmd.submit(), spmd.submit(torch.from_numpy(h)),
             spmd.submit(torch.from_numpy(h * 2.0))]
        out = spmd.flush()
        assert torch.equal(out[t[0]], loop.aggregate())
        assert torch.equal(out[t[2]], loop.aggregate(torch.from_numpy(h * 2)))


@pytest.mark.parametrize("quant", [None, 8])
def test_one_block_ell_spmm_call_a_pass(monkeypatch, quant):
    g, x, h = _graph(90, seed=3)
    _, spmd = _pair(g, x, 4, quant)
    calls = {"block_ell_spmm": 0, "dequantize": 0}

    def spy(name):
        real = getattr(ops, name)

        def wrapped(*a, **k):
            calls[name] += 1
            return real(*a, **k)
        return wrapped

    for name in calls:
        monkeypatch.setattr(ops, name, spy(name))
    spmd.aggregate()
    # one dequantize over the whole uint8 stack, not one a shard
    assert calls == {"block_ell_spmm": 1,
                     "dequantize": 0 if quant is None else 1}
    spmd.aggregate(torch.from_numpy(h))
    assert calls["block_ell_spmm"] == 2
    assert calls["dequantize"] == (0 if quant is None else 1)


def test_spmd_matches_reference_at_one_shard():
    g, x, h = _graph(37, seed=11)
    for quant in (None, 8):
        jserver = js.GNNServer(g, jnp.asarray(x), num_shards=1, mode="spmd",
                               quant=quant, cache=JPlanCache(),
                               tune_kwargs=_tk(g, port=False))
        _, spmd = _pair(g, x, 1, quant)
        for op in (None, h):
            want = np.asarray(jserver.aggregate(
                None if op is None else jnp.asarray(op)))
            got = spmd.aggregate(None if op is None
                                 else torch.from_numpy(op)).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


_REFERENCE_SPMD = r"""
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.serving import GNNServer
from repro.tuning import PlanCache
from repro.tuning.cost_model import MachineModel
from repro.core.graph import CSR

assert jax.device_count() == 4, jax.device_count()
d = np.load(sys.argv[1])
g = CSR(jnp.asarray(d["row_ptr"]), jnp.asarray(d["col_ind"]),
        jnp.asarray(d["val"]), int(d["rows"]))
tk = dict(measure_plan=False, measure_buckets=False, warmup=0, iters=1,
          machine=MachineModel(), block_rows=8, widths=(2, 4, 8))
out = {}
for quant in (None, 8):
    server = GNNServer(g, jnp.asarray(d["x"]), num_shards=4, mode="spmd",
                       quant=quant, cache=PlanCache(), tune_kwargs=tk)
    tag = "f32" if quant is None else "int8"
    out[tag + "_resident"] = np.asarray(server.aggregate())
    out[tag + "_dense"] = np.asarray(server.aggregate(jnp.asarray(d["h"])))
np.savez(sys.argv[2], **out)
print("REFERENCE-SPMD-OK")
"""


def test_spmd_matches_reference_on_four_forced_host_devices(tmp_path):
    g, x, h = _graph(88, seed=5)
    np.savez(tmp_path / "in.npz", row_ptr=np.asarray(g.row_ptr),
             col_ind=np.asarray(g.col_ind), val=np.asarray(g.val),
             rows=g.num_rows, x=x, h=h)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", _REFERENCE_SPMD,
                        str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert "REFERENCE-SPMD-OK" in r.stdout, r.stdout + r.stderr
    want = np.load(tmp_path / "out.npz")
    for quant, tag in ((None, "f32"), (8, "int8")):
        for slots in (1, 4):      # one stack; a slot a forced host device
            _, spmd = _pair(g, x, 4, quant, slots=slots)
            assert len(spmd._bundles) == slots
            np.testing.assert_allclose(spmd.aggregate().numpy(),
                                       want[tag + "_resident"],
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(
                spmd.aggregate(torch.from_numpy(h)).numpy(),
                want[tag + "_dense"], rtol=1e-5, atol=1e-5)


def test_spmd_matches_dense_product_on_ragged_shards():
    g, x, h = _graph(90, seed=7)
    _, spmd = _pair(g, x, 4, exact=True)
    assert len({s.num_rows for s in spmd.shards}) == 2      # 23/23/22/22
    np.testing.assert_allclose(spmd.aggregate().numpy(), _dense_ref(g, x),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(spmd.aggregate(torch.from_numpy(h)).numpy(),
                               _dense_ref(g, h), rtol=1e-5, atol=1e-5)


def test_serving_mesh():
    mesh = serving_mesh(4, CPU)
    assert (mesh.shape, mesh.axis_names, mesh.device) == \
        ((4,), (SHARD_AXIS,), torch.device("cpu"))
    assert SHARD_AXIS == J_SHARD_AXIS
    assert serving_mesh(2, [CPU, "cpu"]).device == torch.device("cpu")
    with pytest.raises(ValueError, match="num_shards"):
        serving_mesh(0, CPU)


@pytest.mark.parametrize("case", ["degree_sorted", "block_rows", "devices"])
def test_spmd_refusals(case):
    g, x, _ = _graph(40, seed=2)
    xt = torch.from_numpy(x)
    if case == "degree_sorted":
        tk = dict(_tk(g), layout="degree_sorted")
        with pytest.raises(ValueError) as want:
            js.GNNServer(g, jnp.asarray(x), num_shards=1, mode="spmd",
                         cache=JPlanCache(),
                         tune_kwargs=dict(_tk(g, port=False),
                                          layout="degree_sorted"))
        with pytest.raises(ValueError, match="degree-sorted") as got:
            GNNServer(to_port(g), xt, num_shards=2, mode="spmd",
                      cache=PlanCache(), tune_kwargs=tk, devices=[CPU])
        assert str(got.value) == str(want.value)
    elif case == "block_rows":
        shards = partition_csr(to_port(g), 2)
        plans = [plan_shard(s, xt, cache=PlanCache(),
                            tune_kwargs=dict(_tk(g), block_rows=br))
                 for s, br in zip(shards, (8, 16))]
        with pytest.raises(ValueError, match="one block_rows"):
            _spmd_slots(shards, plans, xt, serving_mesh(2, CPU))
    else:
        kw = dict(num_shards=2, mode="spmd", cache=PlanCache(),
                  tune_kwargs=_tk(g))
        with pytest.raises(ValueError, match="slot 1 is a 'meta' device"):
            GNNServer(to_port(g), xt, devices=[CPU, "meta"], **kw)
        with pytest.raises(ValueError, match="got 3: a slot holds at least"):
            GNNServer(to_port(g), xt, devices=[CPU] * 3, **kw)


def _delta(g):
    """Replace one edge of a row by a local column it lacks, and give a
    later row an edge to a far column (the first shard's halo grows)."""
    rp, ci = np.asarray(g.row_ptr), np.asarray(g.col_ind)
    row = int(np.flatnonzero(np.diff(rp) >= 2)[0])
    cols = ci[rp[row]:rp[row + 1]]
    new = next(c for c in range(g.num_rows) if c not in cols)
    far = g.num_rows - 1
    return ([(row, int(new), 0.5), (row + 1, far, 2.0)],
            [(row, int(cols[0]))])


@pytest.mark.parametrize("quant", [None, 8])
def test_spmd_edge_updates_equal_loop_mode(quant):
    g, x, h = _graph(60, seed=9)
    loop, spmd = _pair(g, x, 3, quant)
    adds, dels = _delta(g)
    r_loop = loop.apply_edge_updates(adds, dels)
    r_spmd = spmd.apply_edge_updates(adds, dels)
    for key in ("patched", "retuned", "untouched"):
        assert r_loop[key] == r_spmd[key], key
    assert spmd.stats["edge_updates"] == 1
    for op in (None, torch.from_numpy(h)):
        assert torch.equal(spmd.aggregate(op), loop.aggregate(op))


def test_spmd_runtime_results_equal_flush():
    g, x, h = _graph(70, seed=4)
    _, server = _pair(g, x, 4)
    hh = torch.from_numpy(h)
    t0, t1 = server.submit(), server.submit(hh)
    sync = server.flush()
    with ServingRuntime(server, max_batch=3, max_delay_ms=20.0) as rt:
        reqs = [rt.submit(), rt.submit(hh)] + [rt.submit() for _ in range(6)]
        assert torch.equal(reqs[0].result(30), sync[t0])
        assert torch.equal(reqs[1].result(30), sync[t1])
        assert all(torch.equal(r.result(30), sync[t0]) for r in reqs[2:])
        snap = rt.snapshot()
    assert snap["counters"]["completed"] == 8
    assert snap["counters"]["batches"] >= 2
