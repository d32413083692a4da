"""The port's kernel wrappers on the CPU: the edge cases they must handle
(the empty graph, an explicit ``live_w``), the inputs they refuse, the
launch counters, and the build rules (``sm_90a``, no silent fallback when
``nvcc`` is missing).  Cases loop inside tests, so the file stays smaller
than the JAX package's test files (see tests/test_torch_core.py)."""
from __future__ import annotations

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.core.graph import ELL as JELL
from repro.core.graph import ell_live_widths as jlive_widths
from repro.core.sampling import sample_csr_to_ell as jsample
from repro.kernels import ref as jref
from repro_torch.core.graph import CSR, ELL
from repro_torch.core.sampling import sample_csr_to_block_ell
from repro_torch.gnn import evaluate, init_gcn, make_dataset
from repro_torch.kernels import _build, ops
from repro_torch.kernels import aes_sample as aes_mod
from repro_torch.kernels import block_ell_spmm as block_mod
from repro_torch.kernels import ell_spmm as ell_mod
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


def test_build_names_sm90a_and_tracks_sources():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    for name in _build.KERNELS:
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
        assert (_build.CSRC / f"{name}.cu").exists()
    assert len({_build.library_path(n) for n in _build.KERNELS}) == 6


def test_build_without_nvcc_raises_instead_of_falling_back(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
