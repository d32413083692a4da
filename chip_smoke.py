#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0, no result line) on failure:

1. Device: the card's name and power limit, as ``nvidia-smi`` gives them.
2. Build: every CUDA kernel from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` for ``sm_90a``, one compiler process per source.
3. Kernel parity: each kernel against its plain PyTorch version on the
   card, on the four adversarial conformance graphs of the test suite
   (rebuilt here from their seeds) and a ragged random graph with a hub row,
   at W in {1, 16, 128}: the sampler and its live widths bit-exact (at W
   in {1, 3, 16, 127, 128, 256}, also on rows whose sampled prefix ends
   in an edge to column 0 of value +-0.0), float SpMM to 1e-5, the
   uint8 gather to 1e-4, the fused layer (f32/u8/u16 B, H in {1, 5, 41},
   both activations, plus one F = H = 2048 case) to 1e-4; the
   dequantization bit-exact on the reference's test shapes; the blocked
   SpMM (f32 to 1e-5, u8/u16 to 1e-4) on BlockELLs stitched from the same
   graphs at block_rows in {1, 256, 4096} with mixed strategies, over one
   to three width buckets and a partial partition, plus a "full" block
   more than 1024 slots wide; then the two group-gather kernels
   (``ell_spmm``, ``block_ell_spmm``) at F in {1, 3, 64, 128, 130, 2048},
   on f32, uint8 and uint16 B, at W = 1, W = 2048 (a hub row of
   2048 live slots) and on rows with no live slot, the blocked kernel on a
   3000-slot "full" block and bit-identical to its plain version in f32.
4. Training: ``make_dataset("reddit", scale=1.0, max_avg_degree=None)``
   (232,965 nodes, the published average degree); GCN and GraphSAGE
   trained on it by ``train_model`` with its defaults (hidden 64, 150
   epochs of the reference's AdamW, the exact aggregation), which must
   launch no kernel, lower the train loss and reach an ideal (exact) test
   accuracy above 0.8; seconds an epoch and peak device memory logged.
   Main path: the trained models through ``evaluate`` at the paper's
   configuration (``repro_torch.configs``: hidden 64, W=128): strategies
   full/aes/afs/sfs on the ``torch`` and ``cuda`` backends, aes on
   ``cuda_fused``, aes with int8 features on ``cuda``, and for GCN the
   fused layers (``fuse_layers=True``, aes) on ``torch``, on ``cuda`` and
   on ``cuda`` with int8 features; then ``ops.dequantize`` of the uint8
   features.  Each line logs ``accuracy_lost_vs_full``, the accuracy of
   ``full`` on ``torch`` for the model minus the path's (the paper's
   metric).  The kernel backends' logits (kept by a forward hook on the
   model, or from ``infer_logits`` for the fused layers, which call no
   module) must match the eager backend's to 1e-4 and their accuracies to
   0.001, and the fused ``cuda`` logits the unfused ``cuda`` ones
   (``full`` runs no kernel and sums in atomic order, so it is only
   logged; the int8 paths re-quantize their hidden layer, so their
   aggregations and fused layers are held one by one on identical
   operands); every kernel's launch counter must have moved, and the
   ``cuda`` aes paths (unfused, fused, int8) must decode no live width
   from the ELL (``ell_live_widths``): the sampler kernel writes them.
   Then the presampled path, its launch counts set to 0 just before it and
   read just after: the trained GCN through
   ``make_presampled_agg(adj, W, "aes", "cuda")`` (one ``aes_sample`` and
   two ``ell_spmm`` launches) against ``"torch"``, logits to 1e-4 and
   accuracies to 0.001.
   Then the tuned path, its launch counts set to 0 just before it and read
   just after: ``evaluate(strategy="auto")`` for GCN and GraphSAGE at
   ``granularity="block"`` (``tune_blocked``'s defaults: 4096-row blocks,
   widths 16-256, at most 3 width buckets; f32 and int8, natural and
   degree-sorted) and ``granularity="graph"``, and GCN's fused layers with
   ``strategy="auto"``; each cold (tuning) and warm (plan-cache hit), every
   blocked ``evaluate`` launching the blocked kernel; each plan's ``cuda``
   logits held against the port's ``torch`` backend on the same plan
   (1e-4, accuracies to 0.001), each line with ``accuracy_lost_vs_full``;
   then the host costs the tuned path adds (the CSR digest pass and the
   features hash of a quantized plan, on the input and a hidden layer).
   The kernel checks of the int8 layers and of phase 5 keep random
   parameters from a numpy seed: they hold kernels, not accuracy.
5. Kernel times at the main path's shapes (CUDA events around batches of
   back-to-back calls), beside the plain version's time, the bound and,
   for the SpMM, one ``torch.sparse.mm`` on the same sampled matrix; for
   the sampler also ``ell_live_widths`` on its ELL, the decode its live
   widths spare each consumer, and a zero fill of its two outputs, the
   write alone; for
   the fused layer also the port's unfused pipeline (``ell_spmm`` +
   ``torch.matmul`` + bias + ReLU) on the same operands, its bytes and
   operations bounds (its transform counted at the 3xTF32 rate) and the
   time of its gather and of its transform alone; the blocked SpMM
   on the tuned GCN BlockELL (natural layout, f32 and u8), beside
   ``torch.sparse.mm`` on the CSR of the same live slots, ``ell_spmm`` on
   the same live slots and ``ell_spmm`` at W=128 on the same graph.  Both
   SpMMs also at the GCN's layer-2 width (F = 64, its hidden features),
   f32 and uint8.  The dequantization beside
   ``torch.addcmul``, Eq. 2 in one call.

The last two lines of standard output are the ``{"kernels": [...]}`` line
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
import inspect
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM device memory rate (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores (data sheet), FLOP/s.
FP32_FLOP_PER_S = 67e12
#: H100 SXM dense TF32 tensor-core rate (data sheet), FLOP/s; the fused
#: layer's 3xTF32 transform issues three TF32 products per product, so it
#: runs at a third of it.
TF32_FLOP_PER_S = 495e12

#: W and the hidden width of the paper's reddit configurations, read from
#: ``repro_torch.configs`` by :func:`main` (the port is imported there)
W_MAIN = HIDDEN = None
TIMING_BATCH = 20   # calls between one pair of CUDA events
TIMING_REPS = 7     # batches; the median is kept
PLAIN_REPS = 3      # single calls of a plain version; the median is kept
PARITY_HIDDEN = (1, 5, 41)  # fused-layer widths H of phase 3
#: F of phase 3's gather cases: 1 and 3 (scalar loads), 64 and 128 (vector
#: loads; 16- and 32-lane rows), 130 (ragged), 2048 (16 passes)
GATHER_FEATS = (1, 3, 64, 128, 130, 2048)
#: W of phase 3's sampler cases: 1, 3 and 127 (one slot a lane), 16, 128
#: and 256 (four slots a lane; 256 in two passes)
SAMPLER_WIDTHS = (1, 3, 16, 127, 128, 256)
#: per-block (strategy, width) cycle of the blocked parity cases
BLOCK_CONFIGS = (("aes", 16), ("full", 0), ("sfs", 8), ("afs", 64))


def log(obj) -> None:
    print(json.dumps(obj) if not isinstance(obj, str) else obj, flush=True)


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------

def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: graphs for the parity checks
# ---------------------------------------------------------------------------

def random_csr(np, csr_from_edges, rng, num_nodes, avg_deg, skew, device):
    """tests/conftest.py:random_csr, draw for draw, built by the port."""
    raw = rng.pareto(skew, num_nodes) + 0.2 if skew else np.ones(num_nodes)
    deg = np.minimum((raw / raw.mean() * avg_deg).astype(np.int64),
                     num_nodes * 4)
    src = (np.concatenate([rng.integers(0, num_nodes, d) for d in deg])
           if deg.sum() else np.zeros(0, np.int64))
    dst = np.repeat(np.arange(num_nodes), deg)
    val = rng.normal(size=len(src)).astype(np.float32)
    return csr_from_edges(src, dst, num_nodes, val, device=device)


def parity_graphs(np, csr_from_edges, device):
    """The four graphs of tests/test_conformance.py plus a ragged random
    graph with one hub row far above every W."""
    g = {"empty": csr_from_edges(np.zeros(0, np.int64),
                                 np.zeros(0, np.int64), 24, device=device)}
    rng = np.random.default_rng(11)
    dst = np.repeat(np.arange(20), 3)
    g["empty_rows"] = csr_from_edges(
        rng.integers(0, 40, dst.shape[0]), dst, 40,
        rng.normal(size=dst.shape[0]).astype(np.float32), device=device)
    rng = np.random.default_rng(13)
    dst = np.concatenate([np.full(160, 7), np.repeat(np.arange(50), 2)])
    g["dense_row"] = csr_from_edges(
        rng.integers(0, 50, dst.shape[0]), dst, 50,
        rng.normal(size=dst.shape[0]).astype(np.float32), device=device)
    g["ragged70"] = random_csr(np, csr_from_edges, np.random.default_rng(17),
                               70, 6.0, 0.8, device)
    rng = np.random.default_rng(23)
    n = 3001
    raw = rng.pareto(0.6, n) + 0.2
    deg = (raw / raw.mean() * 24).astype(np.int64)
    deg[n // 3] = 40000
    dst = np.repeat(np.arange(n), deg)
    g["ragged_hub"] = csr_from_edges(
        rng.integers(0, n, dst.shape[0]), dst, n,
        rng.normal(size=dst.shape[0]).astype(np.float32), device=device)
    return g


def check_parity(P, device, errs) -> None:
    """Phase 3: every kernel against its plain version on small graphs."""
    torch, np = P.torch, P.np
    graphs = parity_graphs(np, P.csr_from_edges, device)
    check_sampler(P, graphs, device, errs)
    cases = 0
    for gi, (name, g) in enumerate(graphs.items()):
        feat = (60, 33)[gi % 2]
        x = torch.from_numpy(np.random.default_rng(gi).normal(
            size=(g.num_rows, feat)).astype(np.float32)).to(device)
        qf = P.quantize(x, 8)
        meta = (qf.scale, qf.x_min)
        for W in (1, 16, 128):
            ell = P.ops.aes_sample(g, W)          # held by check_sampler
            live = ell.live_w
            plain = P.ell_mod.ell_spmm_plain
            for kernel, got, want, tol in (
                    ("ell_spmm", P.ops.ell_spmm(ell, x, live),
                     plain(ell.val, ell.col, live, x), 1e-5),
                    ("fused_aes_spmm", P.ops.fused_aes_spmm(g, x, W),
                     P.fused_mod.fused_aes_spmm_plain(
                         g.row_ptr, g.col_ind, g.val, x, W), 1e-5),
                    ("ell_spmm_u8",
                     P.ops.ell_spmm(ell, qf.q, live, quantized_meta=meta),
                     plain(ell.val, ell.col, live, qf.q, meta), 1e-4)):
                torch.testing.assert_close(
                    got, want, rtol=tol, atol=tol,
                    msg=lambda m, k=kernel, n=name, w=W: f"{k} {n} W={w}: {m}")
                errs[kernel].append(float((got - want).abs().max())
                                    if got.numel() else 0.0)
            check_fused_layer(P, ell, live, x, (qf, P.quantize(x, 16)), errs)
            cases += 1
    check_wide_fused_layer(P, graphs["ragged70"], device, errs)
    check_dequantize(P, device, errs)
    check_block_parity(P, graphs, device, errs)
    check_gather_parity(P, graphs, device, errs)
    for kernel, e in errs.items():
        log({"phase": "parity", "kernel": kernel, "cases": len(e),
             "max_abs_err": max(e)})


def zero_tail_csr(P, device):
    """tests/test_torch_gpu.py:zero_tail_csr: 40 rows (every 4th empty)
    whose sampled prefixes end in an edge to column 0 of value 0.0 or -0.0
    (rows 5-7), and two 600-edge hubs whose even / odd edges are such
    edges (rows 9, 11)."""
    torch, np = P.torch, P.np
    rng = np.random.default_rng(41)
    cols, vals = [], []
    for r in range(40):
        d = int(rng.integers(1, 10)) if r % 4 else 0
        cols.append(rng.integers(1, 40, d))
        vals.append(rng.normal(size=d))
    cols[5], vals[5] = np.array([4, 0]), np.array([1.5, 0.0])
    cols[6], vals[6] = np.array([7, 3, 0]), np.array([2.0, 1.0, -0.0])
    cols[7], vals[7] = np.zeros(3, np.int64), np.array([0.0, -0.0, 0.0])
    for r, first in ((9, 0), (11, 1)):
        cols[r], vals[r] = rng.integers(1, 40, 600), rng.normal(size=600)
        cols[r][first::2], vals[r][first::2], vals[r][first::4] = 0, 0.0, -0.0
    row_ptr = np.concatenate([[0], np.cumsum([len(c) for c in cols])])
    return P.CSR(*(torch.from_numpy(a).to(device) for a in (
        row_ptr.astype(np.int32), np.concatenate(cols).astype(np.int32),
        np.concatenate(vals).astype(np.float32))), 40)


def check_sampler(P, graphs, device, errs) -> None:
    """The sampler at W in SAMPLER_WIDTHS (one-slot lanes where W % 4 != 0,
    16-byte lanes otherwise, one and two 128-slot passes) on the parity
    graphs and ``zero_tail_csr``: (val, col) bit for bit the plain
    sampler's (-0.0 kept) and the live widths ``ell_live_widths`` of
    them."""
    torch = P.torch
    cases = dict(graphs, zero_tail=zero_tail_csr(P, device))
    for name, g in cases.items():
        for W in SAMPLER_WIDTHS:
            ell = P.ops.aes_sample(g, W)
            pv, pc = P.aes_mod.aes_sample_plain(g.row_ptr, g.col_ind, g.val,
                                                W)
            if not (torch.equal(ell.val.view(torch.int32),
                                pv.view(torch.int32))
                    and torch.equal(ell.col, pc)
                    and torch.equal(ell.live_w, P.ell_live_widths(pv, pc))):
                raise AssertionError(f"aes_sample differs on {name} W={W}")
            errs["aes_sample"].append(0.0)
    log({"phase": "parity_sampler", "graphs": list(cases),
         "widths": list(SAMPLER_WIDTHS)})


def check_block_parity(P, graphs, device, errs) -> None:
    """The blocked SpMM kernel against its plain version: BlockELLs of the
    parity graphs at block_rows 1, 256 and 4096 (a ragged last block),
    one to three width buckets and a partial partition, f32 to 1e-5 and
    u8/u16 to 1e-4, and a graph whose "full" block is over 1024 wide."""
    torch, np = P.torch, P.np
    cases = [(name, g, br) for name, g in graphs.items()
             for br in (1, 256, 4096)]
    cases.append(("wide_full", wide_full_graph(P, device), 16))
    widest_full, calls = 0, 0
    for gi, (name, g, br) in enumerate(cases):
        nb = max(-(-g.num_rows // br), 1)
        bell = P.sample_csr_to_block_ell(
            g, [BLOCK_CONFIGS[b % len(BLOCK_CONFIGS)] for b in range(nb)], br)
        widest_full = max([widest_full] + [
            w for w, s in zip(bell.widths, bell.strategies) if s == "full"])
        x = torch.from_numpy(np.random.default_rng(gi).normal(
            size=(g.num_rows, (60, 33)[gi % 2])).astype(np.float32)).to(device)
        operands = [("block_ell_spmm", x, None, 1e-5)]
        for bits in (8, 16):
            qf = P.quantize(x, bits)
            operands.append(("block_ell_spmm_quant", qf.q,
                             (qf.scale, qf.x_min), 1e-4))
        parts = []
        for k in (1, 2, 3):
            p = P.partition_width_buckets(bell.widths, k)
            if p not in parts:
                parts.append(p)
        if nb > 1:
            parts.append(((max(bell.widths), tuple(range(0, nb, 2))),))
        for buckets in parts:
            for key, b, meta, tol in operands:
                got = P.ops.block_ell_spmm(bell, b, quantized_meta=meta,
                                           buckets=buckets)
                want = P.block_mod.block_ell_spmm_plain(
                    bell.val, bell.col, bell.live_w, b, bell.widths, br,
                    g.num_rows, buckets, meta)
                torch.testing.assert_close(
                    got, want, rtol=tol, atol=tol,
                    msg=lambda m, k=key, n=name, r=br: f"{k} {n} "
                                                       f"block_rows={r}: {m}")
                errs[key].append(float((got - want).abs().max())
                                 if got.numel() else 0.0)
                calls += 1
    if widest_full <= 1024:
        raise AssertionError(f"no full block above 1024 slots "
                             f"(widest {widest_full})")
    log({"phase": "parity_block", "graphs": len(cases), "calls": calls,
         "widest_full_block": widest_full})


def wide_full_graph(P, device):
    """300 rows of 4 edges and one of 3000: at block_rows 16 the blocked
    parity cases make its block "full", 3000 slots wide."""
    np = P.np
    rng = np.random.default_rng(29)
    dst = np.concatenate([np.repeat(np.arange(300), 4), np.full(3000, 150)])
    return P.csr_from_edges(rng.integers(0, 300, dst.shape[0]), dst, 300,
                            rng.normal(size=dst.shape[0]).astype(np.float32),
                            device=device)


def check_gather_parity(P, graphs, device, errs) -> None:
    """The two kernels of the group gather at every F of GATHER_FEATS, on
    f32, uint8 and uint16 B: ``ell_spmm`` on the hub graph at W = 1 and
    W = 2048 (its hub row 2048 live slots) and on the graph with empty
    rows (rows of 0 live slots), to 1e-5 (f32) and 1e-4 (quantized);
    ``block_ell_spmm`` on a BlockELL whose "full" block is 3000 slots
    wide, f32 bit-identical to its plain version, quantized to 1e-4."""
    torch, np = P.torch, P.np
    wide = wide_full_graph(P, device)
    bell = P.sample_csr_to_block_ell(
        wide, [BLOCK_CONFIGS[b % len(BLOCK_CONFIGS)]
               for b in range(-(-wide.num_rows // 16))], 16)
    buckets = P.partition_width_buckets(bell.widths, 3)
    ells = [(name, P.ops.aes_sample(graphs[name], w))
            for name, w in (("ragged_hub", 1), ("ragged_hub", 2048),
                            ("empty_rows", 16))]
    calls = 0
    for fi, feat in enumerate(GATHER_FEATS):
        for gname, g, ell in [(n, graphs[n], e) for n, e in ells] + [
                ("wide_full", wide, None)]:
            x = torch.from_numpy(np.random.default_rng(fi).normal(
                size=(g.num_rows, feat)).astype(np.float32)).to(device)
            operands = [(x, None, "")]
            for bits in (8, 16):
                qf = P.quantize(x, bits)
                operands.append((qf.q, (qf.scale, qf.x_min), f"_u{bits}"))
            for b, meta, tag in operands:
                if ell is None:
                    key = "block_ell_spmm" + ("_quant" if meta else "")
                    tol = 1e-4 if meta else 0.0
                    want = P.block_mod.block_ell_spmm_plain(
                        bell.val, bell.col, bell.live_w, b, bell.widths, 16,
                        wide.num_rows, buckets, meta)
                    got = P.ops.block_ell_spmm(bell, b, quantized_meta=meta,
                                               buckets=buckets)
                else:
                    key = "ell_spmm" + ("_u8" if tag == "_u8" else tag)
                    tol = 1e-4 if meta else 1e-5
                    live = P.ell_live_widths(ell.val, ell.col)
                    want = P.ell_mod.ell_spmm_plain(ell.val, ell.col, live, b,
                                                    meta)
                    got = P.ops.ell_spmm(ell, b, live, quantized_meta=meta)
                torch.testing.assert_close(
                    got, want, rtol=tol, atol=tol,
                    msg=lambda m, k=key, n=gname, f=feat:
                    f"{k} {n} F={f}: {m}")
                errs.setdefault(key, []).append(
                    float((got - want).abs().max()) if got.numel() else 0.0)
                calls += 1
    log({"phase": "parity_gather", "feats": list(GATHER_FEATS),
         "calls": calls, "widest_full_block": max(bell.widths)})


def glorot(np, rng, rows, cols):
    """Weights scaled as the port's model init scales them."""
    return (rng.normal(size=(rows, cols)) / np.sqrt(rows)).astype(np.float32)


def check_fused_layer(P, ell, live, x, quantized, errs, hidden=PARITY_HIDDEN):
    """The fused layer kernel against its plain version: f32, uint8 and
    uint16 B, each H of ``hidden``, both activations, to 1e-4."""
    torch, np = P.torch, P.np
    feat = x.shape[1]
    operands = [("fused_layer", x, None)]
    operands += [("fused_layer_quant", qf.q, (qf.scale, qf.x_min))
                 for qf in quantized]
    for h in hidden:
        rng = np.random.default_rng(100 + h)
        w = torch.from_numpy(glorot(np, rng, feat, h)).to(x.device)
        bias = torch.from_numpy(rng.normal(size=h).astype(np.float32)
                                ).to(x.device)
        for relu in (True, False):
            for key, b, meta in operands:
                got = P.ops.fused_layer_spmm(ell, b, w, bias, live, relu=relu,
                                             quantized_meta=meta)
                want = P.layer_mod.fused_layer_plain(
                    ell.val, ell.col, live, b, w, bias, relu=relu,
                    quantized_meta=meta)
                torch.testing.assert_close(
                    got, want, rtol=1e-4, atol=1e-4,
                    msg=lambda m, k=key: f"{k} F={feat} H={h} relu={relu} "
                                         f"W={ell.val.shape[1]}: {m}")
                errs[key].append(float((got - want).abs().max())
                                 if got.numel() else 0.0)


def check_wide_fused_layer(P, g, device, errs):
    """F = H = 2048, the reference's largest fused layer: a 64 KiB
    aggregation tile, above the 48 KiB a block gets without opting in."""
    torch, np = P.torch, P.np
    x = torch.from_numpy(np.random.default_rng(31).normal(
        size=(g.num_rows, 2048)).astype(np.float32)).to(device)
    ell = P.ops.aes_sample(g, 16)
    live = P.ell_live_widths(ell.val, ell.col)
    check_fused_layer(P, ell, live, x, (P.quantize(x, 8),), errs,
                      hidden=(2048,))


def check_dequantize(P, device, errs):
    """The dequantization kernel against its plain version, bit for bit, on
    the shapes of the reference's tests/test_kernels.py."""
    torch, np = P.torch, P.np
    for shape in ((8, 128), (256, 128), (100, 33), (1, 1)):
        for bits in (8, 16):
            x = torch.from_numpy(np.random.default_rng(3).normal(
                size=shape).astype(np.float32) * 5).to(device)
            qf = P.quantize(x, bits)
            got = P.ops.dequantize(qf.q, qf.scale, qf.x_min, bits=bits)
            if not torch.equal(got, P.dequant_mod.dequantize_plain(
                    qf.q, qf.scale, qf.x_min)):
                raise AssertionError(f"dequantize differs on {shape} "
                                     f"bits={bits}")
            errs["dequantize"].append(0.0)


# ---------------------------------------------------------------------------
# phase 4: training, the main path, the presampled and the tuned paths
# ---------------------------------------------------------------------------

def paper_widths(P) -> tuple:
    """(W, hidden) of the paper's GCN and GraphSAGE reddit configurations,
    which must agree."""
    widths = {(c.sh_width, c.hidden) for c in (
        P.PAPER_GNN_CONFIGS[f"{m}-reddit"] for m in ("gcn", "graphsage"))}
    if len(widths) != 1:
        raise AssertionError(f"reddit configurations differ: {widths}")
    return widths.pop()


def train_phase(P, ds, device) -> dict:
    """Train GCN and GraphSAGE with ``train_model``'s defaults; log seconds
    an epoch (the whole call, synchronized, over its epochs), the loss of
    the seed's initial parameters (``first_loss``, the loss epoch 1
    computes) and of the trained ones (``last_loss``), peak device memory
    and the ideal accuracy.  Fails if training launched a kernel, if the
    loss did not fall or if the ideal accuracy is not above 0.8
    (tests/test_gnn.py's bar).  Returns the trained modules."""
    torch, np = P.torch, P.np
    defaults = {k: v.default for k, v in
                inspect.signature(P.train_model).parameters.items()
                if k in ("hidden", "epochs", "lr", "seed", "weight_decay")}
    modules = {}
    for model in ("gcn", "graphsage"):
        init_fn, _, adj_name = P.MODELS[model]
        adj = getattr(ds, adj_name)

        def loss_of(module):
            with torch.inference_mode():
                return float(P.cross_entropy(module(adj, ds.features,
                                                    P.exact_agg),
                                             ds.labels, ds.train_mask))

        first = loss_of(init_fn(np.random.default_rng(defaults["seed"]),
                                ds.features.shape[1], defaults["hidden"],
                                ds.spec.num_classes, device=device))
        P.ops.reset_launch_counts()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        module, ideal = P.train_model(ds, model, device=device)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launched = {k: n for k, n in P.ops.launch_counts().items() if n}
        last = loss_of(module)
        log({"phase": "train", "model": model, **defaults,
             "seconds": seconds, "s_per_epoch": seconds / defaults["epochs"],
             "first_loss": first, "last_loss": last,
             "ideal_accuracy": ideal, "peak_memory_bytes": peak,
             "memory_before_bytes": base, "kernel_launches": launched})
        if launched:
            raise AssertionError(f"{model} training launched {launched}")
        if not (last < first and ideal > 0.8):
            raise AssertionError(f"{model} training: loss {first} -> {last}, "
                                 f"ideal accuracy {ideal}")
        modules[model] = module
    return modules


def main_path(P, ds, device, modules) -> tuple:
    """Drive ``evaluate`` over the paper's configurations with the trained
    ``modules``; hold each kernel path's logits and accuracy against the
    eager path's.  Returns the kernel launches the run made (counts set to
    0 at its start) and each model's ``full``/``torch`` accuracy."""
    decode = P.graph_mod.ell_live_widths
    decodes = []

    def counted(val, col):
        decodes.append(1)
        return decode(val, col)

    # every decode of the live widths from an ELL goes through this name
    P.graph_mod.ell_live_widths = counted
    try:
        return _main_path(P, ds, device, decodes, modules)
    finally:
        P.graph_mod.ell_live_widths = decode


def _main_path(P, ds, device, decodes, modules) -> tuple:
    torch = P.torch
    full_acc = {}
    P.ops.reset_launch_counts()                   # the main path starts here
    for model in ("gcn", "graphsage"):
        adj = getattr(ds, P.MODELS[model][2])
        params = modules[model]
        # evaluate returns the accuracy only: keep the logits it scored
        captured = []
        hook = params.register_forward_hook(
            lambda _m, _args, out: captured.append(out))
        # (strategy, backend, quantize_bits, fuse_layers); full on torch
        # first: every line's accuracy_lost_vs_full is taken against it
        configs = [(s, b, None, False) for s in ("full", "aes", "afs", "sfs")
                   for b in ("torch", "cuda")]
        configs += [("aes", "cuda_fused", None, False),
                    ("aes", "cuda", 8, False)]
        if model == "gcn":
            configs += [("aes", "torch", None, True),
                        ("aes", "cuda", None, True), ("aes", "cuda", 8, True)]
        logits, accs = {}, {}
        for strategy, backend, bits, fuse in configs:
            kw = dict(sh_width=W_MAIN, strategy=strategy, backend=backend,
                      quantize_bits=bits, fuse_layers=fuse, device=device)
            before, decoded = P.ops.launch_counts(), len(decodes)
            t0 = time.perf_counter()
            acc = P.evaluate(ds, model, params, **kw)
            wall = time.perf_counter() - t0       # evaluate ends in a host read
            after = P.ops.launch_counts()
            per_call = {k: after[k] - before[k] for k in after}
            decoded = len(decodes) - decoded
            if (strategy, backend) == ("aes", "cuda") and decoded:
                raise AssertionError(f"{model} aes cuda bits={bits} "
                                     f"fuse={fuse}: {decoded} live-width "
                                     "decodes; the sampler writes them")
            # the fused layers call no module, so no hook sees their logits:
            # the same call through infer_logits gives them
            out = P.infer_logits(ds, model, params, **kw) if fuse \
                else captured.pop()
            if out.shape != (adj.num_rows, ds.spec.num_classes) or \
                    not bool(torch.isfinite(out).all()) or \
                    not 0.0 <= acc <= 1.0:
                raise AssertionError(f"{model} {strategy} {backend}: bad "
                                     f"logits {tuple(out.shape)} or "
                                     f"accuracy {acc}")
            if fuse and backend == "cuda" and per_call["fused_layer"] != 2:
                raise AssertionError(f"fused {backend} evaluate launched "
                                     f"fused_layer {per_call['fused_layer']} "
                                     "times, not once per layer")
            logits[(strategy, backend, bits, fuse)] = out
            accs[(strategy, backend, bits, fuse)] = acc
            if (strategy, backend) == ("full", "torch"):
                full_acc[model] = acc
            log({"phase": "main_path", "model": model, "strategy": strategy,
                 "backend": backend, "quant_bits": bits,
                 "fuse_layers": fuse, "accuracy": acc,
                 "accuracy_lost_vs_full": full_acc[model] - acc,
                 "evaluate_wall_s": wall, "launches_per_evaluate": per_call,
                 "live_width_decodes": decoded})
        hook.remove()
        # "full" runs the same eager code on both backends (no kernel): its
        # index_add_ sums in atomic order, so it is logged, not compared.
        # The int8 path re-quantizes its hidden layer, where a 1-ulp
        # difference moves a value one level, so its kernel is held layer
        # by layer on identical operands instead (int8_layers)
        full = (logits[("full", "cuda", None, False)]
                - logits[("full", "torch", None, False)]).abs().max()
        log({"phase": "main_path_full_rerun", "model": model,
             "max_abs_diff": float(full)})
        pairs = [((s, "cuda", None, False), (s, "torch", None, False))
                 for s in ("aes", "afs", "sfs")]
        pairs += [(("aes", "cuda_fused", None, False),
                   ("aes", "torch", None, False))]
        if model == "gcn":
            fused = ("aes", "cuda", None, True)
            pairs += [(fused, ("aes", "torch", None, True)),
                      (fused, ("aes", "cuda", None, False))]
        for got_key, want_key in pairs:
            got, want = logits[got_key], logits[want_key]
            torch.testing.assert_close(
                got, want, rtol=1e-4, atol=1e-4,
                msg=lambda m, a=got_key, b=want_key: f"{model} {a} vs {b}: {m}")
            acc_diff = accs[got_key] - accs[want_key]
            log({"phase": "main_path_logits", "model": model,
                 "kernel_path": list(got_key), "eager_path": list(want_key),
                 "max_abs_err": float((got - want).abs().max()),
                 "accuracy_diff": acc_diff})
            if abs(acc_diff) > 1e-3:
                raise AssertionError(f"{model} {got_key} vs {want_key}: "
                                     f"accuracies {acc_diff} apart")
    # the standalone Eq. 2 step (no evaluate path calls it, in either
    # package): the reddit features quantized to uint8, dequantized on the card
    qf = P.quantize(ds.features, 8)
    got = P.ops.dequantize(qf.q, qf.scale, qf.x_min, bits=8)
    if not torch.equal(got, P.dequant_mod.dequantize_plain(qf.q, qf.scale,
                                                           qf.x_min)):
        raise AssertionError("dequantize differs from its plain version on "
                             "the reddit features")
    log({"phase": "main_path_dequantize", "shape": list(got.shape),
         "bit_exact": True})
    launches = P.ops.launch_counts()              # ... and ends here
    log({"phase": "main_path_launches", "launches": launches})
    return launches, full_acc


def presampled_path(P, ds, module, full_acc) -> dict:
    """The trained GCN through ``make_presampled_agg(adj, W_MAIN, "aes",
    backend)``: ``"cuda"`` (the sampler kernel once, ``ell_spmm`` once a
    layer) against ``"torch"``, logits to 1e-4 and accuracies to 0.001.
    Returns the launches of the run (counts set to 0 at its start)."""
    torch = P.torch
    adj, x = ds.gcn_adj, ds.features
    out = {}
    P.ops.reset_launch_counts()                   # the path starts here
    for backend in ("cuda", "torch"):
        t0 = time.perf_counter()
        agg = P.make_presampled_agg(adj, W_MAIN, "aes", backend,
                                    device=adj.device)
        with torch.inference_mode():
            logits = module(adj, x, agg)
        acc = P.accuracy(logits, ds.labels, ds.test_mask)   # a host read
        out[backend] = (logits, acc, time.perf_counter() - t0)
    launches = P.ops.launch_counts()              # ... and ends here
    (got, acc, wall), (want, twin_acc, twin_wall) = out["cuda"], out["torch"]
    if got.shape != (adj.num_rows, ds.spec.num_classes) or \
            not bool(torch.isfinite(got).all()):
        raise AssertionError(f"presampled: bad logits {tuple(got.shape)}")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4,
                               msg=lambda m: f"presampled cuda vs torch: {m}")
    log({"phase": "main_path_presampled", "model": "gcn", "strategy": "aes",
         "W": W_MAIN, "accuracy": acc, "torch_accuracy": twin_acc,
         "accuracy_lost_vs_full": full_acc["gcn"] - acc,
         "max_abs_err": float((got - want).abs().max()), "wall_s": wall,
         "torch_wall_s": twin_wall, "launches": launches})
    want_launches = dict.fromkeys(launches, 0)
    want_launches.update(aes_sample=1, ell_spmm=2)
    if launches != want_launches:
        raise AssertionError(f"presampled path launched {launches}, not "
                             f"{want_launches}")
    if abs(acc - twin_acc) > 1e-3:
        raise AssertionError(f"presampled: accuracy {acc} against {twin_acc}")
    return launches


def _torch_twin(P, plan):
    """The same plan on the port's eager ``torch`` backend."""
    rp = P.dataclasses.replace
    if plan.kind == "block":
        return rp(plan, backend="torch")
    return rp(plan, config=rp(plan.config, backend="torch"))


def _plan_log(P, plan, adj) -> dict:
    if plan.kind == "block":
        bell = plan.bell
        hist = {}
        for w in bell.widths:
            hist[w] = hist.get(w, 0) + 1
        strategies = {}
        for s in bell.strategies:
            strategies[s] = strategies.get(s, 0) + 1
        return {"kind": "block", "layout": plan.row_layout,
                "blocks": bell.num_blocks, "widths": hist,
                "strategies": strategies,
                "buckets": [[w, len(ids)] for w, ids in plan.buckets],
                "measured_bucket_us": list(plan.measured_bucket_us),
                "slots": bell.total_slots, "live_slots": bell.live_edges(),
                "nnz": adj.nnz, "quant_bits": None if plan.quantized is None
                else plan.quantized.bits,
                "measured_spmm_us": plan.measured_spmm_us}
    return {"kind": "global", "config": plan.config.to_dict(),
            "width": plan.ell.width, "nnz": adj.nnz,
            "measured_spmm_us": plan.measured_spmm_us,
            "measured_sample_us": plan.measured_sample_us}


def tuned_path(P, ds, device, modules, full_acc):
    """The tuned path on the card with the trained ``modules``:
    ``evaluate(strategy="auto")`` at block and graph granularity and with
    the fused GCN layers, each cold (it tunes) and warm (a plan-cache
    hit); each plan's ``cuda`` logits and accuracy against the eager
    ``torch`` backend on the same plan.  Returns the launches of the run
    (counts set to 0 at its start) and the GCN's natural f32 blocked
    plan."""
    torch = P.torch
    P.ops.reset_launch_counts()                   # the tuned path starts here
    kept = None
    for model in ("gcn", "graphsage"):
        adj = getattr(ds, P.MODELS[model][2])
        params = modules[model]
        # (granularity, layout, quantize_bits, fuse_layers)
        cases = [("block", layout, bits, False)
                 for layout in ("natural", "degree_sorted")
                 for bits in (None, 8)]
        cases.append(("graph", None, None, False))
        if model == "gcn":
            cases.append(("graph", None, None, True))
        for gran, layout, bits, fuse in cases:
            cache = P.PlanCache()
            kw = dict(strategy="auto", granularity=gran, quantize_bits=bits,
                      fuse_layers=fuse, device=device,
                      tune_kwargs={"layout": layout} if layout else None)
            walls, per_call = [], []
            for _ in range(2):                    # cold (tunes), then warm
                P.obs.reset()
                before = P.ops.launch_counts()
                t0 = time.perf_counter()
                acc = P.evaluate(ds, model, params, plan_cache=cache, **kw)
                walls.append(time.perf_counter() - t0)
                after = P.ops.launch_counts()
                per_call.append({k: after[k] - before[k] for k in after})
                # the tuner's spans: the tuning itself on the cold call, the
                # fingerprint and the cache lookup on the warm one
                spans = [sp.duration_us
                         for sp in P.obs.default_tracer().spans()
                         if sp.name == "tune"]
                if len(walls) == 1:
                    tune_s = sum(spans) / 1e6
                else:
                    lookup_s = sum(spans) / 1e6
            if gran == "block" and min(
                    c["block_ell_spmm"] for c in per_call) < 1:
                raise AssertionError(f"{model} blocked evaluate launched no "
                                     f"block_ell_spmm: {per_call}")
            plan, = cache.plans()
            got = P.infer_logits(ds, model, params, plan_cache=cache, **kw)
            twin = P.PlanCache()
            twin.put(_torch_twin(P, plan))
            want = P.infer_logits(ds, model, params, plan_cache=twin, **kw)
            if got.shape != (adj.num_rows, ds.spec.num_classes) or \
                    not bool(torch.isfinite(got).all()) or \
                    not 0.0 <= acc <= 1.0:
                raise AssertionError(f"{model} auto {gran}: bad logits "
                                     f"{tuple(got.shape)} or accuracy {acc}")
            torch.testing.assert_close(
                got, want, rtol=1e-4, atol=1e-4,
                msg=lambda m: f"{model} auto {gran} {layout} {bits} "
                              f"fuse={fuse}: {m}")
            twin_acc = P.accuracy(want, ds.labels, ds.test_mask)
            log({"phase": "tuned_path", "model": model, "granularity": gran,
                 "layout": layout, "quant_bits": bits, "fuse_layers": fuse,
                 "accuracy": acc, "accuracy_lost_vs_full": full_acc[model]
                 - acc, "torch_twin_accuracy": twin_acc,
                 "evaluate_wall_s": walls[1],
                 "cold_evaluate_wall_s": walls[0], "tune_s": tune_s,
                 "warm_tune_lookup_s": lookup_s,
                 "launches_per_evaluate": per_call[1],
                 "cold_launches": per_call[0], "plan": _plan_log(P, plan, adj),
                 "vs_torch_max_abs_err": float((got - want).abs().max())})
            if abs(acc - twin_acc) > 1e-3:
                raise AssertionError(f"{model} auto {gran} {layout} {bits} "
                                     f"fuse={fuse}: accuracy {acc} against "
                                     f"the torch twin's {twin_acc}")
            if (model, gran, layout, bits) == ("gcn", "block", "natural",
                                               None):
                kept = plan
    launches = P.ops.launch_counts()              # ... and ends here
    log({"phase": "tuned_path_launches", "launches": launches})
    host_costs(P, ds)
    return launches, kept


def host_costs(P, ds) -> None:
    """What the tuned path adds on the host, each a device-to-host copy and
    a blake2b pass: the CSR digest pass of a cold tune (on tensors of a new
    identity, so the digest memo misses) and the features hash that guards
    a quantized plan, on the input features and on a hidden layer."""
    torch = P.torch
    adj = ds.gcn_adj
    fresh = P.CSR(adj.row_ptr.clone(), adj.col_ind.clone(), adj.val.clone(),
                  adj.num_cols)
    hidden = torch.randn((adj.num_rows, HIDDEN), device=adj.device)
    out = {}
    for key, fn in (("csr_digest_s", lambda: P.fingerprint(fresh)),
                    ("features_hash_s",
                     lambda: P.features_fingerprint(ds.features)),
                    ("hidden_hash_s", lambda: P.features_fingerprint(hidden))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        out[key] = time.perf_counter() - t0
    log({"phase": "tuned_path_host_costs", **out,
         "csr_bytes": adj.nnz * 8 + (adj.num_rows + 1) * 4,
         "features_bytes": ds.features.numel() * 4,
         "hidden_bytes": hidden.numel() * 4})


# ---------------------------------------------------------------------------
# phase 5: timing helpers
# ---------------------------------------------------------------------------

def time_ms(torch, fn, batch=TIMING_BATCH, reps=TIMING_REPS,
            warmup=3) -> float:
    """Device time of one call, in ms: ``batch`` calls back to back between
    one pair of CUDA events, divided by ``batch``; the median of ``reps``
    such batches.  The host queues the calls faster than the card runs
    them, so the wrapper's own host time stays out of the reading."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def host_ms(torch, fn, batch=TIMING_BATCH) -> float:
    """Host time of one call, in ms, when ``batch`` calls are issued back to
    back without waiting for the card: where it reaches :func:`time_ms`'s
    reading, that reading is set by the host, not by the kernel."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(batch):
        fn()
    t = (time.perf_counter() - t0) / batch * 1e3
    torch.cuda.synchronize()
    return t


def bound_parts(nbytes: float, flops: float,
                tf32x3_flops: float = 0.0) -> tuple:
    """(ms for the bytes over the memory rate, ms for the operations over
    their rates): float32 ones on the float32 pipe, 3xTF32 ones at a third
    of the TF32 tensor-core rate."""
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            (flops / FP32_FLOP_PER_S
             + tf32x3_flops / (TF32_FLOP_PER_S / 3)) * 1e3)


def bound(nbytes: float, flops: float, tf32x3_flops: float = 0.0) -> tuple:
    """Least time the card could take, the larger of :func:`bound_parts`,
    and which of the two it is: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = bound_parts(nbytes, flops, tf32x3_flops)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int8_layers(P, ds, device, errs) -> None:
    """The int8 main path's aggregations, each held against the eager
    executor on the same operand: both re-quantize the identical hidden
    activation, so only the uint8 gather kernel differs."""
    torch, np = P.torch, P.np
    qf = P.quantize(ds.features, 8)
    for model in ("gcn", "graphsage"):
        init_fn, _, adj_name = P.MODELS[model]
        params = init_fn(np.random.default_rng(0), ds.features.shape[1],
                         HIDDEN, ds.spec.num_classes, device=device)

        def agg(csr, h):
            got = P.PlanExecutor().run_ell(
                P.sample(csr, W_MAIN, "aes", backend="cuda"), h,
                backend="cuda", quantized=qf, requant_guard=True)
            want = P.PlanExecutor().run_ell(
                P.sample(csr, W_MAIN, "aes"), h, backend="torch",
                quantized=qf, requant_guard=True)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
            errs["ell_spmm_u8"].append(float((got - want).abs().max()))
            return got

        with torch.inference_mode():
            params(getattr(ds, adj_name), P.dequantize(qf), agg)
            if model == "gcn":
                fused_int8_layers(P, ds, params, qf, errs)
    log({"phase": "int8_layers", "max_abs_err": max(errs["ell_spmm_u8"]),
         "fused_layer_max_abs_err": max(errs["fused_layer_int8"])})


def fused_int8_layers(P, ds, params, qf, errs) -> None:
    """The int8 fused GCN layers, each against the eager executor on the
    same operand (the kernel's output feeds the next layer of both)."""
    torch = P.torch
    ell = P.sample(ds.gcn_adj, W_MAIN, "aes", backend="cuda")
    h = P.dequantize(qf)
    for w, b, relu in ((params.w1, params.b1, True),
                       (params.w2, params.b2, False)):
        got = P.PlanExecutor().run_fused_layer(
            ell, h, w, b, relu=relu, backend="cuda", quantized=qf,
            requant_guard=True)
        want = P.PlanExecutor().run_fused_layer(
            ell, h, w, b, relu=relu, backend="torch", quantized=qf,
            requant_guard=True)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        errs["fused_layer_int8"].append(float((got - want).abs().max()))
        h = got


def gcn_hidden(P, ds, ell, live):
    """The GCN's hidden features, the F = 64 operand of its second
    aggregation: layer 1 (F = 128 -> 64, ReLU) of a GCN with random
    parameters from seed 0 (the untrained initialisation), on the kernel
    path's W = 128 aggregation."""
    torch, np = P.torch, P.np
    x = ds.features
    params = P.MODELS["gcn"][0](np.random.default_rng(0), x.shape[1], HIDDEN,
                                ds.spec.num_classes, device=x.device)
    w1, b1 = params.w1.detach(), params.b1.detach()
    return torch.relu(P.ops.ell_spmm(ell, x, live) @ w1 + b1).contiguous()


def kernel_times(P, ds, device, launches, errs, timer, plain_timer):
    """Phase 5: each kernel at the main path's shapes (GCN's adjacency,
    W=128, the F=128 input features, the GCN's two layers) against its
    plain version (timed by ``plain_timer``: it repeats the kernel's
    arithmetic and is no yardstick of speed), with its bound and, for the
    SpMM, ``torch.sparse.mm`` on the same matrix; the ELL SpMM also at
    the GCN's layer-2 width (F = 64, its hidden features), f32 and uint8.
    Returns the entries and the hidden features."""
    torch, ops = P.torch, P.ops
    adj, x = ds.gcn_adj, ds.features
    ell = ops.aes_sample(adj, W_MAIN)
    live = ell.live_w
    hidden = gcn_hidden(P, ds, ell, live)
    rows, feat = adj.num_rows, x.shape[1]
    n_live = int(live.sum())
    live_mask = torch.arange(W_MAIN, device=device)[None, :] < live[:, None]
    uniq = int(torch.unique(ell.col[live_mask]).numel())
    qf = P.quantize(x, 8)
    meta = (qf.scale, qf.x_min)
    spmm_plain = P.ell_mod.ell_spmm_plain
    fused_plain = P.fused_mod.fused_aes_spmm_plain

    def check(got, want, tol, key):
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        errs[key].append(float((got - want).abs().max()))

    sv, sc = P.aes_mod.aes_sample_plain(adj.row_ptr, adj.col_ind, adj.val,
                                        W_MAIN)
    if not (torch.equal(ell.val, sv) and torch.equal(ell.col, sc)
            and torch.equal(live, P.ell_live_widths(sv, sc))):
        raise AssertionError("aes_sample differs from its plain version on "
                             "the main path's graph")
    check(ops.ell_spmm(ell, x, live), spmm_plain(ell.val, ell.col, live, x),
          1e-5, "ell_spmm")
    check(ops.ell_spmm(ell, qf.q, live, quantized_meta=meta),
          spmm_plain(ell.val, ell.col, live, qf.q, meta), 1e-4,
          "ell_spmm_u8")
    check(ops.fused_aes_spmm(adj, x, W_MAIN),
          fused_plain(adj.row_ptr, adj.col_ind, adj.val, x, W_MAIN), 1e-5,
          "fused_aes_spmm")

    # torch.sparse (cuSPARSE on the card) on the same sampled matrix
    crow = torch.zeros(rows + 1, dtype=torch.int64, device=device)
    crow[1:] = torch.cumsum(live.long(), 0)
    a_sparse = torch.sparse_csr_tensor(crow, ell.col[live_mask].long(),
                                       ell.val[live_mask], (rows, rows))
    torch.testing.assert_close(torch.sparse.mm(a_sparse, x),
                               ops.ell_spmm(ell, x, live),
                               rtol=1e-4, atol=1e-4)

    # bytes: each input read once — only what this run's data needs: the
    # live ELL slots, the sampled CSR entries, the B rows the live slots
    # name — and each output written once; gather_bound_ms instead charges
    # one B row per live slot (no reuse in any cache)
    flops = 2.0 * n_live * feat
    b_rows = uniq * feat * 4
    out_bytes = rows * feat * 4
    csr_read = (rows + 1) * 4 + n_live * 8
    kernels = []

    def entry(name, fn, plain, nbytes, flops, library, err_key, **extra):
        t_bound, by = bound(nbytes, flops)
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{extra.pop('cu')}",
            "replaces": extra.pop("replaces"), "launches": launches[name],
            "max_abs_err": max(errs[err_key]),
            "ms": timer(fn), "plain_ms": plain_timer(plain),
            "bound_ms": t_bound, "bound_by": by,
            "library_ms": None if library is None else timer(library),
            "host_ms": host_ms(torch, fn), **extra})

    ell_in = n_live * 8 + rows * 4                # live (val, col) + live_w

    def ell_width(b):
        """``ell_spmm`` on ``b`` (f32) and on ``b`` quantized to uint8,
        each checked against its plain version, then timed."""
        f = b.shape[1]
        qb = P.quantize(b, 8)
        mb = (qb.scale, qb.x_min)
        check(ops.ell_spmm(ell, b, live), spmm_plain(ell.val, ell.col, live, b),
              1e-5, "ell_spmm")
        check(ops.ell_spmm(ell, qb.q, live, quantized_meta=mb),
              spmm_plain(ell.val, ell.col, live, qb.q, mb), 1e-4,
              "ell_spmm_u8")
        out = {"F": f, "ms": timer(lambda: ops.ell_spmm(ell, b, live)),
               "plain_ms": plain_timer(lambda: spmm_plain(ell.val, ell.col,
                                                          live, b)),
               "bound_ms": bound(ell_in + uniq * f * 4 + rows * f * 4,
                                 2.0 * n_live * f)[0],
               "library_ms": timer(lambda: torch.sparse.mm(a_sparse, b))}
        out["u8"] = {"ms": timer(lambda: ops.ell_spmm(
                         ell, qb.q, live, quantized_meta=mb)),
                     "plain_ms": plain_timer(lambda: spmm_plain(
                         ell.val, ell.col, live, qb.q, mb)),
                     "bound_ms": bound(ell_in + uniq * f + rows * f * 4,
                                       2.0 * n_live * f)[0]}
        return out

    f64 = ell_width(hidden)
    entry("ell_spmm", lambda: ops.ell_spmm(ell, x, live),
          lambda: spmm_plain(ell.val, ell.col, live, x),
          ell_in + b_rows + out_bytes, flops,
          lambda: torch.sparse.mm(a_sparse, x), "ell_spmm",
          cu="ell_spmm.cu", replaces="src/repro/kernels/ell_spmm.py:111",
          gather_bound_ms=(ell_in + n_live * feat * 4 + out_bytes)
          / HBM_BYTES_PER_S * 1e3,
          u8={"ms": timer(lambda: ops.ell_spmm(ell, qf.q, live,
                                               quantized_meta=meta)),
              "plain_ms": plain_timer(lambda: spmm_plain(
                  ell.val, ell.col, live, qf.q, meta)),
              "bound_ms": bound(ell_in + uniq * feat + out_bytes, flops)[0],
              "max_abs_err": max(errs["ell_spmm_u8"])},
          f64=f64,
          shape={"rows": rows, "W": W_MAIN, "F": feat, "live_slots": n_live,
                 "distinct_b_rows": uniq})
    # the plain version: the sampler and the decode of its live widths;
    # beside it the decode alone, which the kernel's live widths spare
    # each consumer of the ELL (not a library call for the same function),
    # and the write alone: outputs of the sampler's shapes zero-filled
    zero_val, zero_col = torch.empty_like(ell.val), torch.empty_like(ell.col)
    entry("aes_sample", lambda: ops.aes_sample(adj, W_MAIN),
          lambda: P.ell_live_widths(*P.aes_mod.aes_sample_plain(
              adj.row_ptr, adj.col_ind, adj.val, W_MAIN)),
          csr_read + rows * W_MAIN * 8 + rows * 4, 0.0, None, "aes_sample",
          cu="aes_sample.cu", replaces="src/repro/kernels/aes_sample.py:83",
          live_width_decode_ms=timer(
              lambda: P.ell_live_widths(ell.val, ell.col)),
          zero_fill_ms=timer(lambda: (zero_val.zero_(), zero_col.zero_())),
          shape={"rows": rows, "W": W_MAIN, "nnz": adj.nnz,
                 "live_slots": n_live})
    entry("fused_aes_spmm", lambda: ops.fused_aes_spmm(adj, x, W_MAIN),
          lambda: fused_plain(adj.row_ptr, adj.col_ind, adj.val, x, W_MAIN),
          csr_read + b_rows + out_bytes, flops, None, "fused_aes_spmm",
          cu="fused_spmm.cu", replaces="src/repro/kernels/fused_spmm.py:160",
          gather_bound_ms=(csr_read + n_live * feat * 4 + out_bytes)
          / HBM_BYTES_PER_S * 1e3,
          shape={"rows": rows, "W": W_MAIN, "F": feat, "nnz": adj.nnz})
    kernels.append(fused_layer_entry(P, ds, ell, live, launches, errs, timer,
                                     plain_timer, ell_in, uniq))
    kernels.append(dequantize_entry(P, x, launches, errs, timer,
                                    plain_timer))
    return kernels, hidden


def block_entry(P, ds, plan, hidden, launches, errs, timer, plain_timer,
                ell_ms) -> dict:
    """The blocked SpMM on the tuned GCN BlockELL (its buckets, F=128),
    f32 and u8, beside its plain version, ``torch.sparse.mm`` on the CSR of
    the same live slots, ``ell_spmm`` on the same live slots (the BlockELL
    padded to one ELL of its widest width) and ``ell_spmm`` at W=128 on the
    same graph; the same at the GCN's layer-2 width (F = 64,
    ``hidden``)."""
    torch, ops = P.torch, P.ops
    bell, x, buckets = plan.bell, ds.features, plan.buckets
    rows, feat, br = bell.num_rows, x.shape[1], bell.block_rows
    qf = P.quantize(x, 8)
    meta = (qf.scale, qf.x_min)

    def kernel(b=x, m=None):
        return ops.block_ell_spmm(bell, b, quantized_meta=m, buckets=buckets)

    def plain(b=x, m=None):
        return P.block_mod.block_ell_spmm_plain(
            bell.val, bell.col, bell.live_w, b, bell.widths, br, rows,
            buckets, m)

    got = kernel()
    torch.testing.assert_close(got, plain(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kernel(qf.q, meta), plain(qf.q, meta),
                               rtol=1e-4, atol=1e-4)
    errs["block_ell_spmm"].append(float((got - plain()).abs().max()))
    # the live slots as a CSR, rows in order, slots in order within a row
    vals, cols = [], []
    for b in range(bell.num_blocks):
        v, c = bell.block_segment(b)
        live = torch.arange(v.shape[1], device=x.device)[None, :] \
            < bell.live_w[b * br:(b + 1) * br, None]
        vals.append(v[live])
        cols.append(c[live])
    live_w = bell.live_w[:rows]
    crow = torch.zeros(rows + 1, dtype=torch.int64, device=x.device)
    crow[1:] = torch.cumsum(live_w.long(), 0)
    col = torch.cat(cols)
    a_sparse = torch.sparse_csr_tensor(crow, col.long(), torch.cat(vals),
                                       (rows, bell.num_cols))
    torch.testing.assert_close(torch.sparse.mm(a_sparse, x), got,
                               rtol=1e-4, atol=1e-4)
    # the same operand as one ELL at the plan's widest width (its extra
    # slots dead), for ell_spmm on the same live slots
    ev = torch.zeros((bell.padded_rows, bell.max_width), device=x.device)
    ec = torch.zeros_like(ev, dtype=torch.int32)
    for b in range(bell.num_blocks):
        v, c = bell.block_segment(b)
        ev[b * br:(b + 1) * br, :v.shape[1]] = v
        ec[b * br:(b + 1) * br, :v.shape[1]] = c
    same = P.ELL(ev[:rows], ec[:rows], bell.num_cols)
    torch.testing.assert_close(ops.ell_spmm(same, x, live_w), got,
                               rtol=1e-5, atol=1e-5)
    n_live = int(live_w.sum())
    uniq = int(torch.unique(col).numel())
    # live (val, col) + live_w + the (id, offset, width) entry of each
    # block + the named B rows + the output once
    ell_in = n_live * 8 + bell.padded_rows * 4 + bell.num_blocks * 24
    flops = 2.0 * n_live * feat
    t_bound, by = bound(ell_in + uniq * feat * 4 + rows * feat * 4, flops)

    # layer 2's width: the hidden features, f32 and uint8
    f2 = hidden.shape[1]
    qh = P.quantize(hidden, 8)
    mh = (qh.scale, qh.x_min)
    got2 = kernel(hidden)
    torch.testing.assert_close(got2, plain(hidden), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(kernel(qh.q, mh), plain(qh.q, mh), rtol=1e-4,
                               atol=1e-4)
    errs["block_ell_spmm"].append(float((got2 - plain(hidden)).abs().max()))
    f64 = {"F": f2, "ms": timer(lambda: kernel(hidden)),
           "plain_ms": plain_timer(lambda: plain(hidden)),
           "bound_ms": bound(ell_in + uniq * f2 * 4 + rows * f2 * 4,
                             2.0 * n_live * f2)[0],
           "library_ms": timer(lambda: torch.sparse.mm(a_sparse, hidden)),
           "ell_spmm_same_operand_ms": timer(
               lambda: ops.ell_spmm(same, hidden, live_w)),
           "u8": {"ms": timer(lambda: kernel(qh.q, mh)),
                  "plain_ms": plain_timer(lambda: plain(qh.q, mh)),
                  "bound_ms": bound(ell_in + uniq * f2 + rows * f2 * 4,
                                    2.0 * n_live * f2)[0]}}
    return {
        "name": "block_ell_spmm", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/block_ell_spmm.cu",
        "replaces": "src/repro/kernels/ell_spmm.py:246",
        "launches": launches["block_ell_spmm"],
        "max_abs_err": max(errs["block_ell_spmm"]
                           + errs["block_ell_spmm_quant"]),
        "ms": timer(kernel), "plain_ms": plain_timer(plain),
        "bound_ms": t_bound, "bound_by": by,
        "library_ms": timer(lambda: torch.sparse.mm(a_sparse, x)),
        "host_ms": host_ms(torch, kernel),
        "ell_spmm_same_operand_ms": timer(
            lambda: ops.ell_spmm(same, x, live_w)),
        "ell_spmm_same_operand_host_ms": host_ms(
            torch, lambda: ops.ell_spmm(same, x, live_w)),
        "ell_spmm_w128_ms": ell_ms,
        "u8": {"ms": timer(lambda: kernel(qf.q, meta)),
               "plain_ms": plain_timer(lambda: plain(qf.q, meta)),
               "bound_ms": bound(ell_in + uniq * feat + rows * feat * 4,
                                 flops)[0]},
        "f64": f64,
        "shape": {"rows": rows, "F": feat, "block_rows": br,
                  "blocks": bell.num_blocks, "layout": plan.row_layout,
                  "buckets": [[w, len(ids)] for w, ids in buckets],
                  "slots": bell.total_slots, "live_slots": n_live,
                  "distinct_b_rows": uniq, "max_width": bell.max_width}}


def fused_layer_entry(P, ds, ell, live, launches, errs, timer, plain_timer,
                      ell_in, uniq) -> dict:
    """The fused layer at the main path's GCN layer shapes (random
    parameters from seed 0, the untrained initialisation): layer 1
    (F=128 -> H=64, ReLU) in f32 and with the uint8 features, layer 2
    (F=64 -> H=41, no activation) on layer 1's output; each beside the
    port's unfused pipeline on the same operands (the ``ell_spmm``
    kernel, ``torch.matmul``, bias, ReLU).  The bound
    counts the transform's operations at the 3xTF32 rate the kernel uses
    and the aggregation's on the float32 pipe; both bounds are reported.
    The split of each layer: ``gather_phase_ms`` is the kernel at H = 1,
    where its time is nearly all the gather; ``transform_phase_ms`` the
    kernel with every live width 0, where it gathers nothing and runs W's
    staging, the transform and the stores."""
    torch, np, ops = P.torch, P.np, P.ops
    x = ds.features
    rows, feat = x.shape
    n_live = int(live.sum())
    params = P.MODELS["gcn"][0](np.random.default_rng(0), feat, HIDDEN,
                                ds.spec.num_classes, device=x.device)
    w1, b1, w2, b2 = (t.detach() for t in (params.w1, params.b1, params.w2,
                                           params.b2))
    qf = P.quantize(x, 8)

    def kernel(b, w, bias, relu, meta, live_w=live):
        return ops.fused_layer_spmm(ell, b, w, bias, live_w, relu=relu,
                                    quantized_meta=meta)

    def layer(b, w, bias, relu, meta=None):
        """The layer checked against its plain version and the unfused
        pipeline, then timed; returns (its output, its numbers)."""
        def plain():
            return P.layer_mod.fused_layer_plain(
                ell.val, ell.col, live, b, w, bias, relu=relu,
                quantized_meta=meta)

        def unfused():
            out = ops.ell_spmm(ell, b, live, quantized_meta=meta) @ w + bias
            return torch.relu(out) if relu else out

        got, want = kernel(b, w, bias, relu, meta), plain()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(unfused(), want, rtol=1e-4, atol=1e-4)
        errs["fused_layer"].append(float((got - want).abs().max()))
        f_in, h_out = w.shape
        nbytes = (ell_in + uniq * f_in * b.element_size() + f_in * h_out * 4
                  + h_out * 4 + rows * h_out * 4)
        work = (nbytes, 2.0 * n_live * f_in, 2.0 * rows * f_in * h_out)
        t_bound, by = bound(*work)
        t_bytes, t_ops = bound_parts(*work)
        w_1, bias_1 = w[:, :1].contiguous(), bias[:1].contiguous()
        return got, {"ms": timer(lambda: kernel(b, w, bias, relu, meta)),
                     "plain_ms": plain_timer(plain),
                     "unfused_ms": timer(unfused), "bound_ms": t_bound,
                     "bound_by": by, "bytes_bound_ms": t_bytes,
                     "operations_bound_ms": t_ops, "bytes": nbytes,
                     "gather_phase_ms": timer(
                         lambda: kernel(b, w_1, bias_1, relu, meta)),
                     "transform_phase_ms": timer(
                         lambda: kernel(b, w, bias, relu, meta, no_live))}

    no_live = torch.zeros_like(live)
    h1, layer1 = layer(x, w1, b1, True)
    _, layer2 = layer(h1, w2, b2, False)
    _, layer1_u8 = layer(qf.q, w1, b1, True, (qf.scale, qf.x_min))
    return {
        "name": "fused_layer", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_layer.cu",
        "replaces": "src/repro/kernels/fused_layer.py:121",
        "launches": launches["fused_layer"],
        "max_abs_err": max(errs["fused_layer"] + errs["fused_layer_quant"]
                           + errs["fused_layer_int8"]),
        **layer1, "library_ms": None,
        "layer2": {**layer2, "F": HIDDEN, "H": ds.spec.num_classes},
        "u8": layer1_u8,
        "shape": {"rows": rows, "W": W_MAIN, "F": feat, "H": HIDDEN,
                  "live_slots": n_live, "distinct_b_rows": uniq}}


def dequantize_entry(P, x, launches, errs, timer, plain_timer) -> dict:
    """Eq. 2 over the reddit features quantized to uint8 (and uint16);
    the library call is ``torch.addcmul(x_min, q, scale)``, Eq. 2 in one
    call (it may contract into FMA: its largest difference from the
    kernel is logged)."""
    torch, ops = P.torch, P.ops
    n = x.numel()
    out = {}
    for bits in (8, 16):
        qf = P.quantize(x, bits)

        def fn():
            return ops.dequantize(qf.q, qf.scale, qf.x_min, bits=bits)

        def pl():
            return P.dequant_mod.dequantize_plain(qf.q, qf.scale, qf.x_min)

        if not torch.equal(fn(), pl()):
            raise AssertionError(f"dequantize differs at bits={bits}")
        errs["dequantize"].append(0.0)
        def lib():
            return torch.addcmul(qf.x_min, qf.q, qf.scale)

        t_bound, by = bound(n * (bits // 8) + n * 4, 2.0 * n)
        out[bits] = {"ms": timer(fn), "plain_ms": plain_timer(pl),
                     "bound_ms": t_bound, "bound_by": by,
                     "library_ms": timer(lib),
                     "library_max_abs_diff": float((lib() - fn()).abs().max())}
    return {"name": "dequantize", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dequant.cu",
            "replaces": "src/repro/kernels/dequant.py:45",
            "launches": launches["dequantize"],
            "max_abs_err": max(errs["dequantize"]), **out[8],
            "u16": out[16],
            "shape": {"n": x.shape[0], "f": x.shape[1]}}


def port():
    """The port's modules, imported from ``src/`` next to this script."""
    sys.path.insert(0, str(SRC))
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core import graph as graph_mod
    from repro_torch.core.aes_spmm import sample
    from repro_torch.core.graph import (CSR, ELL, csr_from_edges,
                                        ell_live_widths,
                                        partition_width_buckets)
    from repro_torch.core.quantization import dequantize, quantize
    from repro_torch.core.sampling import sample_csr_to_block_ell
    from repro_torch.configs import PAPER_GNN_CONFIGS
    from repro_torch.exec import PlanExecutor
    from repro_torch.gnn import (evaluate, infer_logits, make_dataset,
                                 make_presampled_agg, train_model)
    from repro_torch.gnn.models import MODELS, exact_agg
    from repro_torch.gnn.train import accuracy, cross_entropy
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import aes_sample as aes_mod
    from repro_torch.kernels import block_ell_spmm as block_mod
    from repro_torch.kernels import dequant as dequant_mod
    from repro_torch.kernels import ell_spmm as ell_mod
    from repro_torch.kernels import fused_layer as layer_mod
    from repro_torch.kernels import fused_spmm as fused_mod
    from repro_torch.tuning import PlanCache, features_fingerprint, fingerprint

    return SimpleNamespace(**{k: v for k, v in locals().items()})


def main() -> None:
    if not (SRC / "repro_torch").is_dir():
        _fail(f"the port is not here: no {SRC / 'repro_torch'}; run this "
              "script from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke test runs "
              "on a CUDA card only")
    P = port()
    global W_MAIN, HIDDEN
    W_MAIN, HIDDEN = paper_widths(P)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.perf_counter()

    # -- 1. device ----------------------------------------------------------
    smi = device_line()
    kind = torch.cuda.get_device_name(0)
    log(smi)
    log({"phase": "device", "nvidia_smi": smi, "torch_name": kind,
         "count": torch.cuda.device_count(), "torch": torch.__version__,
         "cuda": torch.version.cuda})

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    seconds = P._build.build()
    log({"phase": "build", "seconds": seconds,
         "wall_s": time.perf_counter() - t0,
         "libraries": [P._build.library_path(k).name
                       for k in P._build.KERNELS]})
    # ptxas's registers and spill bytes of every kernel instantiation
    log({"phase": "build_resources",
         **{k: {fn: [r["registers"], r["spill_bytes"]]
                for fn, r in P._build.resources(k).items()}
            for k in P._build.KERNELS}})

    # -- 3. kernel parity on small graphs -----------------------------------
    errs = {"aes_sample": [], "ell_spmm": [], "fused_aes_spmm": [],
            "ell_spmm_u8": [], "fused_layer": [], "fused_layer_quant": [],
            "dequantize": [], "block_ell_spmm": [],
            "block_ell_spmm_quant": [], "ell_spmm_u16": []}
    check_parity(P, device, errs)
    torch.cuda.synchronize()

    # -- 4. training, then the main path at full size -----------------------
    t0 = time.perf_counter()
    ds = P.make_dataset("reddit", scale=1.0, seed=0, max_avg_degree=None,
                        device=device)
    row_nnz = ds.gcn_adj.row_nnz()
    log({"phase": "dataset", "name": "reddit", "nodes": ds.gcn_adj.num_rows,
         "edges_raw": ds.csr.nnz, "edges_with_self_loops": ds.gcn_adj.nnz,
         "max_row_nnz": int(row_nnz.max()),
         "rows_above_W": int((row_nnz > W_MAIN).sum()),
         "feat": ds.features.shape[1], "classes": ds.spec.num_classes,
         "build_s": time.perf_counter() - t0})
    modules = train_phase(P, ds, device)
    launches, full_acc = main_path(P, ds, device, modules)
    torch.cuda.synchronize()
    for name, n in launches.items():
        if n <= 0 and name != "block_ell_spmm":
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")
    presampled = presampled_path(P, ds, modules["gcn"], full_acc)
    tuned, plan = tuned_path(P, ds, device, modules, full_acc)
    torch.cuda.synchronize()
    for name in ("block_ell_spmm", "fused_layer"):
        if tuned[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "tuned path")
    launches = {k: n + presampled[k] + tuned[k]
                for k, n in launches.items()}

    errs["fused_layer_int8"] = []
    int8_layers(P, ds, device, errs)

    # -- 5. kernel times at the main path's shapes --------------------------
    timer = functools.partial(time_ms, torch)
    plain_timer = functools.partial(time_ms, torch, batch=1, reps=PLAIN_REPS,
                                    warmup=1)
    kernels, hidden = kernel_times(P, ds, device, launches, errs, timer,
                                   plain_timer)
    kernels.append(block_entry(P, ds, plan, hidden, launches, errs, timer,
                               plain_timer, kernels[0]["ms"]))
    torch.cuda.synchronize()
    log({"phase": "done", "wall_s": time.perf_counter() - t_start})

    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
