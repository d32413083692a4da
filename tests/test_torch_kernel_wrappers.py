"""The port's kernel wrappers on the CPU: the edge cases they must handle
(the empty graph, an explicit ``live_w``), the inputs they refuse, the
launch counters, and the build rules (``sm_90a``, no silent fallback when
``nvcc`` is missing).  Cases loop inside tests, so the file stays smaller
than the JAX package's test files (see tests/test_torch_core.py)."""
from __future__ import annotations

import ctypes
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.graph import ELL as JELL
from repro.core.graph import ell_live_widths as jlive_widths
from repro.core.sampling import sample_csr_to_ell as jsample
from repro.kernels import ref as jref
import repro_torch.core.graph as graph_mod
from repro_torch.core.graph import CSR, ELL, ell_live_widths
from repro_torch.core.sampling import sample_csr_to_block_ell
from repro_torch.exec import PlanExecutor
from repro_torch.gnn import evaluate, init_gcn, make_dataset
from repro_torch.kernels import _build, ops
from repro_torch.kernels import aes_sample as aes_mod
from repro_torch.kernels import block_ell_spmm as block_mod
from repro_torch.kernels import dequant as dequant_mod
from repro_torch.kernels import ell_spmm as ell_mod
from repro_torch.kernels import fused_layer as layer_mod
from repro_torch.kernels import fused_spmm as fused_mod
from repro_torch.tuning import PlanCache

from conftest import random_csr

# one intra-op thread: the suite runs in parallel workers beside timing tests
torch.set_num_threads(1)


def to_port(g) -> CSR:
    return CSR(*(torch.from_numpy(np.array(a)) for a in
                 (g.row_ptr, g.col_ind, g.val)), g.num_cols)


def _jell(g, W):
    val, col = jsample(g.row_ptr, g.col_ind, g.val, W)
    return JELL(val, col, g.num_cols)


def _pell(jell) -> ELL:
    return ELL(torch.from_numpy(np.array(jell.val)),
               torch.from_numpy(np.array(jell.col)), jell.num_cols)


def test_empty_graph_gives_zeros():
    g = random_csr(np.random.default_rng(0), 8, 0.0, skew=0.0)
    b = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 16))
                         .astype(np.float32))
    p = to_port(g)
    ell = ops.aes_sample(p, 4)
    assert ell.val.shape == (8, 4) and not ell.val.any() and \
        not ell.col.any()
    assert not ops.ell_spmm(ell, b).any()
    assert not ops.fused_aes_spmm(p, b, 4).any()


def test_explicit_live_w_bounds_the_sum():
    g = random_csr(np.random.default_rng(5), 30, 10.0, skew=0.8)
    jell = _jell(g, 16)
    live = np.minimum(np.asarray(jlive_widths(jell.val, jell.col)), 3)
    b = np.random.default_rng(6).normal(size=(30, 24)).astype(np.float32)
    mask = np.arange(16)[None, :] < live[:, None]
    want = jref.ell_spmm_rowloop(jnp.where(mask, jell.val, 0), jell.col,
                                 jnp.asarray(b))
    got = ops.ell_spmm(_pell(jell), torch.from_numpy(b),
                       torch.from_numpy(live.astype(np.int32)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_live_w_from_argument_then_ell_then_decode():
    """``ops.ell_spmm`` and ``ops.fused_layer_spmm`` take an explicit
    ``live_w`` first, then the ELL's, then decode it: the three give the
    same output where they agree, and an explicit ``live_w`` shorter than
    the ELL's bounds the sum."""
    g = to_port(random_csr(np.random.default_rng(12), 40, 9.0, skew=0.7))
    b = torch.from_numpy(np.random.default_rng(13).normal(size=(40, 12))
                         .astype(np.float32))
    w, bias = b[:12, :5].contiguous(), b[0, :5].contiguous()
    ell = ops.aes_sample(g, 16)
    bare = ELL(ell.val, ell.col, ell.num_cols)
    short = torch.clamp(ell.live_w, max=2)
    for fn in (lambda e, lw=None: ops.ell_spmm(e, b, lw),
               lambda e, lw=None: ops.fused_layer_spmm(e, b, w, bias, lw)):
        want = fn(bare)                                  # decoded
        assert torch.equal(fn(ell), want)                # from the ELL
        assert torch.equal(fn(bare, ell.live_w), want)   # from the argument
        cut = fn(bare, short)
        assert torch.equal(fn(ell, short), cut)          # argument first
        assert not torch.equal(cut, want)


def test_ell_carries_live_w_and_three_fields_still_work(monkeypatch):
    """``ELL.to`` keeps ``live_w``; a 3-field ``ELL`` has none, decodes on
    demand and runs every consumer; and on CPU tensors the kernel paths of
    ``evaluate`` (``cuda`` aes, float and int8, and the fused ``cuda``
    layers) decode no live width, where an AFS ``cuda`` one must."""
    g = to_port(random_csr(np.random.default_rng(14), 30, 6.0, skew=0.8))
    ell = ops.aes_sample(g, 8)
    assert torch.equal(ell.live_w, ell_live_widths(ell.val, ell.col))
    moved = ell.to("meta")
    assert moved.live_w.device.type == "meta" and \
        moved.live_w.shape == ell.live_w.shape
    assert torch.equal(ell.to("cpu").live_w, ell.live_w)
    bare = ELL(ell.val, ell.col, ell.num_cols)
    assert bare.live_w is None and bare.to("cpu").live_w is None
    assert torch.equal(bare.live_widths(), ell.live_w)
    b = torch.ones((30, 4))
    executor = PlanExecutor()
    for e in (ell, bare):
        torch.testing.assert_close(
            executor.run_ell(e, b, backend="cuda"),
            executor.run_ell(e, b, backend="torch"), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(
            executor.run_fused_layer(e, b, torch.ones((4, 3)), torch.zeros(3),
                                     backend="cuda"),
            executor.run_fused_layer(e, b, torch.ones((4, 3)), torch.zeros(3),
                                     backend="torch"), rtol=1e-5, atol=1e-5)
    decodes = []
    decode = graph_mod.ell_live_widths
    monkeypatch.setattr(graph_mod, "ell_live_widths",
                        lambda v, c: decodes.append(1) or decode(v, c))
    ds = make_dataset("cora", scale=0.01, device="cpu")
    model = init_gcn(np.random.default_rng(0), 96, 8, 7, device="cpu")
    for bits, fuse in ((None, False), (8, False), (None, True), (8, True)):
        evaluate(ds, "gcn", model, sh_width=8, backend="cuda",
                 quantize_bits=bits, fuse_layers=fuse, device="cpu")
    assert decodes == []
    evaluate(ds, "gcn", model, sh_width=8, strategy="afs", backend="cuda",
             device="cpu")
    assert decodes   # the AFS sampler writes no live widths: each layer decodes


def test_wrappers_reject_bad_inputs():
    val = torch.zeros((4, 2))
    col = torch.zeros((4, 2), dtype=torch.int32)
    live = torch.zeros(4, dtype=torch.int32)
    b = torch.zeros((3, 5))
    with pytest.raises(ValueError, match="bf16"):
        ell_mod.ell_spmm(val, col, live, b.to(torch.bfloat16))
    with pytest.raises(ValueError, match="uint8 or uint16"):
        ell_mod.ell_spmm(val, col, live, b, quantized_meta=(1.0, 0.0))
    with pytest.raises(ValueError, match="two scalars"):
        ell_mod.ell_spmm(val, col, live, b.to(torch.uint8),
                         quantized_meta=(torch.ones(2), 0.0))
    with pytest.raises(ValueError, match="int32"):
        ell_mod.ell_spmm(val, col.long(), live, b)
    with pytest.raises(ValueError, match="contiguous"):
        ell_mod.ell_spmm(val, col, live, torch.zeros((5, 3)).T)
    with pytest.raises(ValueError, match="device"):
        ell_mod.ell_spmm(val.to("meta"), col.to("meta"), live.to("meta"),
                         b.to("meta"))
    with pytest.raises(ValueError, match="several devices"):
        ell_mod.ell_spmm(val, col, live, b.to("meta"))
    rp = torch.zeros(5, dtype=torch.int32)
    ci = torch.zeros(0, dtype=torch.int32)
    with pytest.raises(ValueError, match="sh_width"):
        aes_mod.aes_sample(rp, ci, torch.zeros(0), 0)
    with pytest.raises(ValueError, match="shared memory"):
        fused_mod.fused_aes_spmm(rp, ci, torch.zeros(0), b,
                                 fused_mod.MAX_SHARED_BYTES // 8 + 1)
    flat, fcol = torch.zeros(16), torch.zeros(16, dtype=torch.int32)
    blk = dict(widths=(2, 2), block_rows=4, num_rows=7)
    with pytest.raises(ValueError, match="distinct blocks"):
        block_mod.block_ell_spmm(flat, fcol, torch.zeros(8, dtype=torch.int32),
                                 b, buckets=((2, (0, 2)),), **blk)
    with pytest.raises(ValueError, match="live_w"):
        block_mod.block_ell_spmm(flat, fcol, live, b, buckets=(), **blk)
    with pytest.raises(ValueError, match="shorter"):
        block_mod.block_ell_spmm(flat[:8], fcol[:8],
                                 torch.zeros(8, dtype=torch.int32), b,
                                 buckets=(), **blk)


def test_cpu_calls_launch_no_kernel():
    """The launch counters move only where a kernel launches: CPU tensors
    take the plain versions, down to a whole ``evaluate``."""
    ops.reset_launch_counts()
    g = to_port(random_csr(np.random.default_rng(9), 20, 5.0))
    b = torch.ones((20, 8))
    ops.ell_spmm(ops.aes_sample(g, 8), b)
    ops.fused_aes_spmm(g, b, 8)
    ops.fused_layer_spmm(ops.aes_sample(g, 8), b, torch.ones((8, 3)),
                         torch.zeros(3))
    ops.dequantize(torch.zeros((4, 4), dtype=torch.uint8), 1.0, 0.0)
    ops.block_ell_spmm(sample_csr_to_block_ell(g, [("aes", 4)] * 3, 8), b)
    ds = make_dataset("cora", scale=0.01, device="cpu")
    model = init_gcn(np.random.default_rng(0), 96, 8, 7, device="cpu")
    for backend, fuse in (("cuda", False), ("cuda_fused", False),
                          ("cuda", True)):
        evaluate(ds, "gcn", model, sh_width=8, backend=backend,
                 fuse_layers=fuse, quantize_bits=8 if fuse else None,
                 device="cpu")
    # the tuned path on CPU tensors: torch candidates only, no kernel
    evaluate(ds, "gcn", model, strategy="auto", granularity="block",
             quantize_bits=8, plan_cache=PlanCache(),
             tune_kwargs={"block_rows": 64, "widths": (8,)}, device="cpu")
    assert ops.launch_counts() == {"ell_spmm": 0, "aes_sample": 0,
                                   "fused_aes_spmm": 0, "fused_layer": 0,
                                   "dequantize": 0, "block_ell_spmm": 0}


def test_signatures_match_the_c_entry_points():
    """Each wrapper's ctypes argument list against the ``extern "C"``
    entry points of its ``.cu`` source: the same functions, the same
    number of arguments, a pointer where the source takes one and the
    integer width it declares, so a change of one side alone fails here
    and not as a bad launch on the card."""
    kinds = {"int": ctypes.c_int, "int64_t": ctypes.c_int64}
    for name, mod in (("ell_spmm", ell_mod), ("block_ell_spmm", block_mod),
                      ("aes_sample", aes_mod), ("fused_spmm", fused_mod),
                      ("fused_layer", layer_mod), ("dequant", dequant_mod)):
        src = (_build.CSRC / f"{name}.cu").read_text()
        entries = {fn: [p.strip() for p in params.split(",")]
                   for fn, params in re.findall(
                       r'extern "C" int (\w+)\(([^)]*)\)', src)}
        assert set(entries) == set(mod._SIGNATURES), name
        for fn, params in entries.items():
            want = [ctypes.c_void_p if "*" in p else kinds[p.rsplit(" ", 1)[0]]
                    for p in params]
            assert mod._SIGNATURES[fn] == want, fn


def test_build_names_sm90a_and_tracks_sources():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.KERNELS:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
        assert (_build.CSRC / f"{name}.cu").exists()
    assert len({_build.library_path(n) for n in _build.KERNELS}) == 6
    # ptxas's report (-Xptxas -v) is read per entry function
    assert "-v" in _build.NVCC_FLAGS
    f32 = ("_ZN44_GLOBAL__N__097969d6_11_ell_spmm_cu_f6d7c84315ell_spmm_"
           "kernelIfLb1ELi32ELi4EEEvPKfPKiS4_PKT_PfiiiS2_S2_")
    u8 = "_ZN1a17aes_sample_kernelEPKiS1_PKfPfPiii"
    log = f"""ptxas info    : Compiling entry function '{f32}' for 'sm_90a'
ptxas info    : Function properties for {f32}
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 48 registers, 400 bytes cmem[0]
ptxas info    : Function properties for _Z6helperv
    0 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Compiling entry function '{u8}' for 'sm_90a'
ptxas info    : Function properties for {u8}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 20 registers, 400 bytes cmem[0]
"""
    assert _build.parse_ptxas(log) == {
        "ell_spmm_kernel<f32,1,32,4>": {"registers": 48, "spill_bytes": 12},
        "aes_sample_kernel": {"registers": 20, "spill_bytes": 0}}


def test_build_without_nvcc_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
