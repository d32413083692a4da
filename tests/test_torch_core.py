"""Parity of the port's graph builders and samplers with the JAX package:
the same numpy inputs go through both, and every result — CSR arrays,
sampled ELL ``(val, col)``, strategy tables — must be bit-identical.

Each test loops over its cases (graphs x widths) rather than being
parametrized: the suite runs under ``pytest -n 6 --dist loadfile``, which
hands out files largest first, and keeping every ``test_torch_*`` file
smaller than the JAX package's test files leaves their schedule as it
was (tests/test_incremental.py must not follow tests/test_conformance.py
in one worker: they share the process-wide plan cache).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core import graph as jg
from repro.core import sampling as js
from repro_torch.core import graph as tg
from repro_torch.core import sampling as ts

from conftest import random_csr

# one intra-op thread: the suite runs in parallel workers beside timing tests
torch.set_num_threads(1)

WIDTHS = (1, 4, 16, 64, 128)


def to_port(g) -> tg.CSR:
    """A JAX-package CSR as the port's CSR (CPU tensors, same bytes)."""
    return tg.CSR(*(torch.from_numpy(np.array(a)) for a in
                    (g.row_ptr, g.col_ind, g.val)), g.num_cols)


def _edges(g):
    rp = np.asarray(g.row_ptr)
    dst = np.repeat(np.arange(g.num_rows), rp[1:] - rp[:-1])
    return np.asarray(g.col_ind), dst, np.asarray(g.val)


def _conformance(name):
    """The four adversarial graphs of tests/test_conformance.py, rebuilt
    from the same seeds."""
    if name == "empty":
        return jg.csr_from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                 24)
    if name == "empty_rows":
        rng = np.random.default_rng(11)
        dst = np.repeat(np.arange(20), 3)
        src = rng.integers(0, 40, dst.shape[0])
        val = rng.normal(size=dst.shape[0]).astype(np.float32)
        return jg.csr_from_edges(src, dst, 40, val)
    if name == "dense_row":
        rng = np.random.default_rng(13)
        dst = np.concatenate([np.full(160, 7), np.repeat(np.arange(50), 2)])
        src = rng.integers(0, 50, dst.shape[0])
        val = rng.normal(size=dst.shape[0]).astype(np.float32)
        return jg.csr_from_edges(src, dst, 50, val)
    assert name == "ragged70"
    return random_csr(np.random.default_rng(17), 70, 6.0, skew=0.8)


def _band_graph(W: int):
    """Rows on both sides of every Table 1 threshold at width W, plus an
    empty row: nnz in {0, 1, W, W+1, 2W, 2W+1, 36W, 36W+1, 54W, 54W+1, 60W}."""
    nnz = np.array([0, 1, W, W + 1, 2 * W, 2 * W + 1, 36 * W, 36 * W + 1,
                    54 * W, 54 * W + 1, 60 * W])
    rng = np.random.default_rng(W)
    dst = np.repeat(np.arange(nnz.size), nnz)
    src = rng.integers(0, 64, dst.shape[0])
    val = rng.normal(size=dst.shape[0]).astype(np.float32)
    return jg.csr_from_edges(src, dst, 64, val)


GRAPHS = {
    "empty": lambda W: _conformance("empty"),
    "empty_rows": lambda W: _conformance("empty_rows"),
    "dense_row": lambda W: _conformance("dense_row"),
    "ragged70": lambda W: _conformance("ragged70"),
    "random64": lambda W: random_csr(np.random.default_rng(1), 64, 6.0,
                                     skew=1.2),
    "skewed96": lambda W: random_csr(np.random.default_rng(2), 96, 4.0,
                                     skew=0.7),
    "bands": _band_graph,
}


def _assert_csr_equal(got: tg.CSR, want, msg):
    for a, b in ((got.row_ptr, want.row_ptr), (got.col_ind, want.col_ind),
                 (got.val, want.val)):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, msg
        np.testing.assert_array_equal(a.numpy(), b, err_msg=msg)
    assert got.num_cols == want.num_cols, msg


def test_graph_builders_bit_identical():
    for name, make in GRAPHS.items():
        g = make(16)
        src, dst, val = _edges(g)
        built = tg.csr_from_edges(src, dst, g.num_rows, val, device="cpu")
        _assert_csr_equal(built, g, name)
        _assert_csr_equal(tg.add_self_loops(built), jg.add_self_loops(g),
                          name)
        _assert_csr_equal(tg.gcn_normalize(built), jg.gcn_normalize(g), name)
        _assert_csr_equal(tg.mean_normalize(built), jg.mean_normalize(g),
                          name)
        _assert_csr_equal(
            tg.csr_from_edges(src, dst, g.num_rows, device="cpu"),
            jg.csr_from_edges(src, dst, g.num_rows), name)
        # duplicate edges may accumulate in another order: float tolerance
        np.testing.assert_allclose(tg.csr_to_dense(built).numpy(),
                                   np.asarray(jg.csr_to_dense(g)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_pad_csr_to_ell_and_live_widths_bit_identical():
    for name, make in GRAPHS.items():
        g = make(4)
        want = jg.pad_csr_to_ell(g)
        got = tg.pad_csr_to_ell(to_port(g))
        np.testing.assert_array_equal(got.val.numpy(), np.asarray(want.val),
                                      err_msg=name)
        np.testing.assert_array_equal(got.col.numpy(), np.asarray(want.col),
                                      err_msg=name)
        np.testing.assert_array_equal(
            tg.ell_live_widths(got.val, got.col).numpy(),
            np.asarray(jg.ell_live_widths(want.val, want.col)), err_msg=name)


@pytest.mark.parametrize("strategy", ["aes", "afs", "sfs"])
def test_sampled_ell_bit_identical(strategy):
    """Every graph (incl. rows on both sides of every Table 1 threshold) at
    W in {1, 4, 16, 64, 128}."""
    for name, make in GRAPHS.items():
        for W in WIDTHS:
            g = make(W)
            p = to_port(g)
            want_val, want_col = js.STRATEGIES[strategy](
                g.row_ptr, g.col_ind, g.val, W)
            got_val, got_col = ts.STRATEGIES[strategy](
                p.row_ptr, p.col_ind, p.val, W)
            case = f"{strategy} {name} W={W}"
            assert got_val.dtype == torch.float32, case
            assert got_col.dtype == torch.int32, case
            np.testing.assert_array_equal(got_col.numpy(),
                                          np.asarray(want_col), err_msg=case)
            np.testing.assert_array_equal(got_val.numpy(),
                                          np.asarray(want_val), err_msg=case)


def test_strategy_table_and_slot_offsets_bit_identical():
    for W in WIDTHS:
        # the `bands` graph really puts rows in each band of Table 1
        nnz = np.asarray(_band_graph(W).row_nnz())
        band = np.select([nnz <= t * np.minimum(nnz, W)
                          for t in js._R_THRESHOLDS], range(4), default=4)
        assert set(band.tolist()) == set(range(5)), W

        row_nnz = np.arange(0, 70 * W + 2, max(W // 4, 1), dtype=np.int32)
        want = js.get_sample_strategy(jnp.asarray(row_nnz), W)
        got = ts.get_sample_strategy(torch.from_numpy(row_nnz), W)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"W={W}")
        want_off, want_valid = js.slot_offsets(W, want, jnp.asarray(row_nnz))
        got_off, got_valid = ts.slot_offsets(W, got,
                                             torch.from_numpy(row_nnz))
        np.testing.assert_array_equal(got_valid.numpy(),
                                      np.asarray(want_valid))
        np.testing.assert_array_equal(got_off.numpy(), np.asarray(want_off))
        i = np.arange(32, dtype=np.int32)[None, :]
        np.testing.assert_array_equal(
            ts.hash_start_ind(torch.from_numpy(i), got.W[:, None] * 3,
                              got.N[:, None]).numpy(),
            np.asarray(js.hash_start_ind(jnp.asarray(i), want.W[:, None] * 3,
                                         want.N[:, None])))


def test_sampling_rate_matches():
    for name in ("ragged70", "skewed96", "empty"):
        for W in (4, 16):
            g = GRAPHS[name](W)
            assert ts.sampling_rate(to_port(g).row_ptr, W) == \
                js.sampling_rate(g.row_ptr, W), (name, W)
