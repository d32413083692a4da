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
   at W in {1, 16, 128}: the sampler bit-exact, float SpMM to 1e-5, the
   uint8 gather to 1e-4, the fused layer (f32/u8/u16 B, H in {1, 5, 41},
   both activations, plus one F = H = 2048 case) to 1e-4; the
   dequantization bit-exact on the reference's test shapes.
4. Main path: ``make_dataset("reddit", scale=1.0, max_avg_degree=None)``
   (232,965 nodes, the published average degree) through ``evaluate`` for
   GCN and GraphSAGE at the paper's configuration (hidden 64, W=128), with
   random parameters from a numpy seed: strategies aes/afs/sfs/full on the
   ``torch`` and ``cuda`` backends, aes on ``cuda_fused``, aes with int8
   features on ``cuda``, and for GCN the fused layers
   (``fuse_layers=True``, aes) on ``torch``, on ``cuda`` and on ``cuda``
   with int8 features; then ``ops.dequantize`` of the uint8 features.  The
   kernel backends' logits (kept by a forward hook on the model, or from
   ``infer_logits`` for the fused layers, which call no module) must match
   the eager backend's to 1e-4, and the fused ``cuda`` logits the unfused
   ``cuda`` ones (``full`` runs no kernel and sums in atomic order, so it
   is only logged; the int8 paths re-quantize their hidden layer, so their
   aggregations and fused layers are held one by one on identical
   operands); every kernel's launch counter must have moved.
5. Kernel times at the main path's shapes (CUDA events around batches of
   back-to-back calls), beside the plain version's time, the bound and,
   for the SpMM, one ``torch.sparse.mm`` on the same sampled matrix; for
   the fused layer also the port's unfused pipeline (``ell_spmm`` +
   ``torch.matmul`` + bias + ReLU) on the same operands.

The last two lines of standard output are the ``{"kernels": [...]}`` line
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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

W_MAIN = 128        # configs/gnn_paper.py: sh_width
HIDDEN = 64         # configs/gnn_paper.py: hidden
TIMING_BATCH = 20   # calls between one pair of CUDA events
TIMING_REPS = 7     # batches; the median is kept
PLAIN_REPS = 3      # single calls of a plain version; the median is kept
PARITY_HIDDEN = (1, 5, 41)  # fused-layer widths H of phase 3


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
    cases = 0
    for gi, (name, g) in enumerate(graphs.items()):
        feat = (60, 33)[gi % 2]
        x = torch.from_numpy(np.random.default_rng(gi).normal(
            size=(g.num_rows, feat)).astype(np.float32)).to(device)
        qf = P.quantize(x, 8)
        meta = (qf.scale, qf.x_min)
        for W in (1, 16, 128):
            ell = P.ops.aes_sample(g, W)
            pv, pc = P.aes_mod.aes_sample_plain(g.row_ptr, g.col_ind, g.val,
                                                W)
            if not (torch.equal(ell.val, pv) and torch.equal(ell.col, pc)):
                raise AssertionError(f"aes_sample differs on {name} W={W}")
            errs["aes_sample"].append(0.0)
            live = P.ell_live_widths(ell.val, ell.col)
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
    for kernel, e in errs.items():
        log({"phase": "parity", "kernel": kernel, "cases": len(e),
             "max_abs_err": max(e)})


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
# phase 4: the main path
# ---------------------------------------------------------------------------

def main_path(P, ds, device) -> dict:
    """Drive ``evaluate`` over the paper's configurations; hold each kernel
    path's logits against the eager path's.  Returns the kernel launches
    the run made (counts set to 0 at its start)."""
    torch, np = P.torch, P.np
    P.ops.reset_launch_counts()                   # the main path starts here
    for model in ("gcn", "graphsage"):
        init_fn, _, adj_name = P.MODELS[model]
        adj = getattr(ds, adj_name)
        params = init_fn(np.random.default_rng(0), ds.features.shape[1],
                         HIDDEN, ds.spec.num_classes, device=device)
        # evaluate returns the accuracy only: keep the logits it scored
        captured = []
        hook = params.register_forward_hook(
            lambda _m, _args, out: captured.append(out))
        # (strategy, backend, quantize_bits, fuse_layers)
        configs = [(s, b, None, False) for s in ("aes", "afs", "sfs", "full")
                   for b in ("torch", "cuda")]
        configs += [("aes", "cuda_fused", None, False),
                    ("aes", "cuda", 8, False)]
        if model == "gcn":
            configs += [("aes", "torch", None, True),
                        ("aes", "cuda", None, True), ("aes", "cuda", 8, True)]
        logits = {}
        for strategy, backend, bits, fuse in configs:
            kw = dict(sh_width=W_MAIN, strategy=strategy, backend=backend,
                      quantize_bits=bits, fuse_layers=fuse, device=device)
            before = P.ops.launch_counts()
            t0 = time.perf_counter()
            acc = P.evaluate(ds, model, params, **kw)
            wall = time.perf_counter() - t0       # evaluate ends in a host read
            after = P.ops.launch_counts()
            per_call = {k: after[k] - before[k] for k in after}
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
            log({"phase": "main_path", "model": model, "strategy": strategy,
                 "backend": backend, "quant_bits": bits,
                 "fuse_layers": fuse, "accuracy": acc,
                 "evaluate_wall_s": wall, "launches_per_evaluate": per_call})
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
            log({"phase": "main_path_logits", "model": model,
                 "kernel_path": list(got_key), "eager_path": list(want_key),
                 "max_abs_err": float((got - want).abs().max())})
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
    return launches


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


def bound(nbytes: float, flops: float) -> tuple:
    """Least time the card could take: bytes over the memory rate or
    float32 operations over the float32 rate, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
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


def kernel_times(P, ds, device, launches, errs, timer, plain_timer) -> list:
    """Phase 5: each kernel at the main path's shapes (GCN's adjacency,
    W=128, the F=128 input features, the GCN's two layers) against its
    plain version (timed by ``plain_timer``: it repeats the kernel's
    arithmetic and is no yardstick of speed), with its bound and, for the
    SpMM, ``torch.sparse.mm`` on the same matrix."""
    torch, ops = P.torch, P.ops
    adj, x = ds.gcn_adj, ds.features
    ell = ops.aes_sample(adj, W_MAIN)
    live = P.ell_live_widths(ell.val, ell.col)
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
    if not (torch.equal(ell.val, sv) and torch.equal(ell.col, sc)):
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
            **extra})

    ell_in = n_live * 8 + rows * 4                # live (val, col) + live_w
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
          shape={"rows": rows, "W": W_MAIN, "F": feat, "live_slots": n_live,
                 "distinct_b_rows": uniq})
    entry("aes_sample", lambda: ops.aes_sample(adj, W_MAIN),
          lambda: P.aes_mod.aes_sample_plain(adj.row_ptr, adj.col_ind,
                                             adj.val, W_MAIN),
          csr_read + rows * W_MAIN * 8, 0.0, None, "aes_sample",
          cu="aes_sample.cu", replaces="src/repro/kernels/aes_sample.py:83",
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
    return kernels


def fused_layer_entry(P, ds, ell, live, launches, errs, timer, plain_timer,
                      ell_in, uniq) -> dict:
    """The fused layer at the main path's GCN layers (its parameters from
    the main path's seed): layer 1 (F=128 -> H=64, ReLU) in f32 and with
    the uint8 features, layer 2 (F=64 -> H=41, no activation) on layer 1's
    output; each beside the port's unfused pipeline on the same operands
    (the ``ell_spmm`` kernel, ``torch.matmul``, bias, ReLU).
    ``gather_phase_ms`` is layer 1 at H = 1, where the kernel's time is
    nearly all its gather phase."""
    torch, np, ops = P.torch, P.np, P.ops
    x = ds.features
    rows, feat = x.shape
    n_live = int(live.sum())
    params = P.MODELS["gcn"][0](np.random.default_rng(0), feat, HIDDEN,
                                ds.spec.num_classes, device=x.device)
    w1, b1, w2, b2 = (t.detach() for t in (params.w1, params.b1, params.w2,
                                           params.b2))
    qf = P.quantize(x, 8)

    def kernel(b, w, bias, relu, meta):
        return ops.fused_layer_spmm(ell, b, w, bias, live, relu=relu,
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
        flops = 2.0 * rows * f_in * h_out + 2.0 * n_live * f_in
        t_bound, by = bound(nbytes, flops)
        return got, {"ms": timer(lambda: kernel(b, w, bias, relu, meta)),
                     "plain_ms": plain_timer(plain),
                     "unfused_ms": timer(unfused), "bound_ms": t_bound,
                     "bound_by": by}

    h1, layer1 = layer(x, w1, b1, True)
    _, layer2 = layer(h1, w2, b2, False)
    _, layer1_u8 = layer(qf.q, w1, b1, True, (qf.scale, qf.x_min))
    w_h1, b_h1 = w1[:, :1].contiguous(), b1[:1].contiguous()
    return {
        "name": "fused_layer", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/fused_layer.cu",
        "replaces": "src/repro/kernels/fused_layer.py:121",
        "launches": launches["fused_layer"],
        "max_abs_err": max(errs["fused_layer"] + errs["fused_layer_quant"]
                           + errs["fused_layer_int8"]),
        **layer1, "library_ms": None,
        "gather_phase_ms": timer(lambda: kernel(x, w_h1, b_h1, True, None)),
        "layer2": {**layer2, "F": HIDDEN, "H": ds.spec.num_classes},
        "u8": layer1_u8,
        "shape": {"rows": rows, "W": W_MAIN, "F": feat, "H": HIDDEN,
                  "live_slots": n_live, "distinct_b_rows": uniq}}


def dequantize_entry(P, x, launches, errs, timer, plain_timer) -> dict:
    """Eq. 2 over the reddit features quantized to uint8 (and uint16)."""
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
        t_bound, by = bound(n * (bits // 8) + n * 4, 2.0 * n)
        out[bits] = {"ms": timer(fn), "plain_ms": plain_timer(pl),
                     "bound_ms": t_bound, "bound_by": by}
    return {"name": "dequantize", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dequant.cu",
            "replaces": "src/repro/kernels/dequant.py:45",
            "launches": launches["dequantize"],
            "max_abs_err": max(errs["dequantize"]), **out[8],
            "library_ms": None, "u16": out[16],
            "shape": {"n": x.shape[0], "f": x.shape[1]}}


def port():
    """The port's modules, imported from ``src/`` next to this script."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    from repro_torch.core.aes_spmm import sample
    from repro_torch.core.graph import csr_from_edges, ell_live_widths
    from repro_torch.core.quantization import dequantize, quantize
    from repro_torch.exec import PlanExecutor
    from repro_torch.gnn import evaluate, infer_logits, make_dataset
    from repro_torch.gnn.models import MODELS
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import aes_sample as aes_mod
    from repro_torch.kernels import dequant as dequant_mod
    from repro_torch.kernels import ell_spmm as ell_mod
    from repro_torch.kernels import fused_layer as layer_mod
    from repro_torch.kernels import fused_spmm as fused_mod

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

    # -- 3. kernel parity on small graphs -----------------------------------
    errs = {"aes_sample": [], "ell_spmm": [], "fused_aes_spmm": [],
            "ell_spmm_u8": [], "fused_layer": [], "fused_layer_quant": [],
            "dequantize": []}
    check_parity(P, device, errs)
    torch.cuda.synchronize()

    # -- 4. main path at full size ------------------------------------------
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
    launches = main_path(P, ds, device)
    torch.cuda.synchronize()
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "main path")

    errs["fused_layer_int8"] = []
    int8_layers(P, ds, device, errs)

    # -- 5. kernel times at the main path's shapes --------------------------
    kernels = kernel_times(
        P, ds, device, launches, errs, lambda fn: time_ms(torch, fn),
        lambda fn: time_ms(torch, fn, batch=1, reps=PLAIN_REPS, warmup=1))
    torch.cuda.synchronize()
    log({"phase": "done", "wall_s": time.perf_counter() - t_start})

    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
