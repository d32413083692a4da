#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

On a machine with several cards the same command also spreads the spmd
server over the cards (the ``serving_spmd_cards`` line of phase 4).

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
   dequantization bit-exact on the reference's test shapes and with
   per-segment constants (S in {1, 3, 4} segments, lengths that are not
   whole 16-element vectors, unaligned views, an out= slice, n = 0, u8 and
   u16), and equal to one call a segment; the blocked
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
   Then incremental plan maintenance, its launch counts set to 0 just
   before it and read just after: three blocked plans of ``gcn_adj``
   (``tune_blocked``'s defaults with measurement off; natural f32,
   natural int8 with 64 feature rows changed inside the stored range,
   degree-sorted f32), each patched by ``apply_edge_updates`` for two
   deltas drawn from seed 0 (``window``: 128 deletions and 128 additions
   on two adjacent 4096-row blocks; ``churn_1pct``: 1% of the edges, half
   each, on 2% of the rows drawn by (deg + 1)^2); each patch, the merge
   alone and a cold ``tune_blocked`` of the patched graph timed (one
   untimed round, the median of 3); the patched plan equal to the cold
   tune (natural plans: fingerprint, digests, tables, buckets and operand
   bytes; degree-sorted: fingerprint), served from the plan cache with no
   tuning through ``block_ell_spmm``, its output bit-identical to the cold
   plan's (natural plans) and to its ``torch`` twin (int8 to 1e-4), and
   the merge on the card equal to the same call on the CPU; one
   ``incremental`` line a pair, speed ratios logged, not gated.
   Then sharded serving, its launch counts set to 0 just before it and
   read just after (less the launches that only compare or time): a
   4-shard ``GNNServer`` over ``gcn_adj`` (loop mode, all shards on the
   card, ``tune_blocked``'s defaults), f32 and int8, each on a fresh disk
   ``PlanCache``, with ``aggregate`` on the resident and on a dense F = 64
   operand held against the shard plans' ``torch`` twins (f32 0.0, u8
   1e-4) and a two-operand micro-batch against the one-shot results
   (0.0); the int8 server's init-time hashes timed; a warm restart (4
   disk hits, 0 misses); ``sync_baseline``, ``run_batch``'s dispatch time
   beside its completion (under ``set_sync_debug_mode("error")``), its
   host time layer by layer (also with obs off and with the garbage
   collector off), and whether ``Event.synchronize`` releases
   the interpreter lock; ``run_open_loop`` on a ``ServingRuntime``
   (``policy="reject"``) at 0.5x-4x the baseline's rps, 64 requests each,
   half dense, every result equal to the synchronous one;
   ``evaluate(strategy="auto", shards=4)`` for both trained models beside
   the single-device tuned call and within 0.001 of the ``torch`` twins;
   a ``window`` edge update held to the CPU merge's edges and to cold
   tunes of the shards it touched; peak device memory.
   Then sharded serving in spmd mode, its launch counts likewise:
   ``GNNServer(mode="spmd")`` (the 4 shards stacked on the card, one
   ``block_ell_spmm`` launch a global width bucket, at most 3), f32 and
   int8, each on a fresh disk ``PlanCache`` over the loop servers'
   directory (4 disk hits: the same plans), its resident and dense F = 64
   results bit-equal (``torch.equal``) to a loop server's on those plans;
   the launches of one pass (int8: one ``dequantize`` over the stack,
   then the float launches; that launch's own device ms, from a
   ``torch.profiler`` trace, beside its bytes bound); a pass's device ms
   (CUDA events around passes queued
   behind a spin of the card) and host ms beside loop mode's, and its
   dispatch under ``set_sync_debug_mode("error")``; f32 also a
   ``ServingRuntime`` at the synchronous baseline's rps (64 requests, half
   dense) with every result equal to the synchronous one, and a
   ``window`` edge update equal to loop mode's after the same update; a
   degree-sorted plan refused (``serving_spmd*`` lines).
   Then spmd serving over several device slots, its launch counts
   likewise: the 4 shards over ``devices=["cuda:0"] * 2`` and ``* 4``
   (a ``serving_spmd_slots`` line each: the shards split in shard order,
   each slot's stack served by its own pass), f32 and int8, each server on
   the loop servers' disk caches (4 disk hits), resident and dense F = 64
   results ``torch.equal`` to a loop server's and the one-slot server's;
   the launches of one pass (``block_ell_spmm`` once a non-empty global
   bucket a slot, at most slots x 3; int8 one ``dequantize`` a slot); a
   pass's device and host ms beside the one-slot pass's, and its dispatch
   under ``set_sync_debug_mode("error")``.  With more than one card, the
   same over one slot a card, plus a ``ServingRuntime`` burst at the
   synchronous baseline's rps whose results equal ``flush()``'s, its
   achieved rate and rejections beside the baseline's rate (gated, as the
   one-card runtime line is, on equal results and no failure, not on the
   rate) (``serving_spmd_cards``); on one card that line says
   ``"across_cards": "not run"``.
   Then the command lines (``cli_smoke`` lines), each in a process of its
   own on the card as ``python -m`` runs it, with the launches it made:
   ``repro_torch.exec --smoke --json`` (the fused layers against the
   unfused pipeline: ``aes_sample``, ``ell_spmm``, ``fused_layer``),
   ``repro_torch.tuning.autotune --smoke --json``, also with
   ``--granularity block`` and ``--shards 4`` (``block_ell_spmm``), and
   ``repro_torch.tuning.calibration --smoke --json``; each must exit 0
   and end with ``smoke: OK``.
   Then LM serving, its launch counts set to 0 just before it and read
   just after (it launches none of the six kernels): Qwen2-7B
   (``get_config("qwen2-7b")`` unreduced, bfloat16, weights drawn on the
   card from seed 0) served by ``launch.serve.serve`` to 8 requests x
   1,024 prompt tokens (numpy seed 0) x 64 generated tokens on five paths
   (full attention, AES-KV at W = 256 and 64, the int8 cache, the int8
   cache with AES-KV at W = 64) and at W = S_max, whose tokens must equal
   full attention's; each ``lm_serve`` line with prefill and decode
   seconds, tok/s and ms a decode step beside the weight-read bound (the
   parameter bytes over 3.35 TB/s), the host's ms to issue one step and
   the step's ms from an idle card, peak memory and the greedy agreement
   with full attention (the full path also with the device's busy ms and
   kernels a step from a ``torch.profiler`` trace); the gates
   (``lm_serve_gates``): at ``cache_len = P`` the decode step against
   ``forward`` over P + 1 tokens within 2**-5 of the largest logit,
   AES-KV at W = S_max bit-equal to full attention, the int8 cache's
   next-token softmax within 0.05 of the bfloat16 cache's, every logit
   finite; then each of the ten archs' smoke config in float32 on one set
   of weights on the card and on the CPU (``lm_smoke_card_vs_cpu``):
   served tokens equal (token archs), ``forward``'s logits to 1e-4 and
   each decode step's, from the CPU's cache, to 2e-3.
   Then the pattern families, their launch counts set to 0 just before
   and read just after (none launched): Zamba2-7B and xLSTM-350M
   unreduced in bfloat16, weights drawn on the card from seed 0, served to
   the same requests (Zamba2 also with AES-KV at W = 256 and at W = S_max,
   whose tokens must equal full attention's); each ``lm_pattern_serve``
   line with the bytes-a-step bound (weights less the embedding table,
   the shared attention + MLP once an application, recurrent states and
   conv caches read and written, K/V read at the positions the step
   needs), the full path also with the costliest kernels of a step from
   a ``torch.profiler`` trace; the gates (``lm_pattern_serve_gates``):
   the decode step at ``cache_len = P`` against ``forward`` over the
   P + 1 tokens (padded to a whole 128-position scan chunk; later
   positions cannot reach P) within 2**-5 of the largest logit on a
   float32 copy of the weights (in bfloat16 it is logged: the rounding
   of the residual stream compounds over the depth), W = S_max bit-equal
   and every logit finite in both.
   Then LM training, its launch counts likewise (none launched):
   TinyLlama-1.1B unreduced in bfloat16 through ``launch.train``'s step
   (AdamW, remat on) with the token pipeline and the cosine schedule, B 8
   x S 256, 10 steps: s a step, tokens/s beside the 6 N tokens bound at
   the bfloat16 rate, peak memory, first and last loss; 3 steps of
   ``launch.train.main --grad-compress``; xLSTM-350M unreduced, 5 steps
   on one constant batch, whose loss must fall; and at smoke size a run
   failing at an injected step, its checkpoint restored bit for bit and
   a resumed run whose losses match an uninterrupted one's to 1e-3.
   Then the device mesh, each part in a process of its own, so that no
   process group outlives it (none of the six kernels launched):
   ``lm_mesh`` (``python3 chip_smoke.py --lm-mesh``) trains TinyLlama-1.1B
   unreduced, B 8 x S 256, remat on, 3 steps of ``make_train_step`` on
   the plain state and on DTensors placed by the sharding rules over a
   1x1 mesh of a one-rank nccl group (``sharded_step``, under
   ``implicit_replication``), deterministic algorithms on: losses and
   parameters must be ``torch.equal``; s a step of each; then
   ``launch.train.main`` with ``--production-mesh`` and ``--multi-pod``
   must raise ``ValueError`` naming 256 and 512 ranks and leave no group.
   ``lm_dryrun``: ``python -m repro_torch.launch.dryrun`` for
   ``tinyllama-1.1b decode_32k`` and ``qwen2-7b train_4k`` on 16x16 (a
   fake 256-rank group, the model full size under ``FakeTensorMode``),
   each with ``--device cuda`` and again with ``--device cpu``: both OK
   and their JSONs equal in every field but timings and the device.
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
   f32 and uint8.  ``ell_spmm`` also on Reddit's layer-1 operand at its
   published size (232,965 x 602, f32 and uint8, above the card's L2)
   over a random graph of 121 edges a row on average (about 75 live
   slots a row at W = 128; the ``ell_panels`` line, the ``f602`` entry
   of the ``ell_spmm`` row): one launch and one panel launch counted a
   checked call, bit for bit its plain version, timed beside the same
   kernel in row order, the plain version, the bound and
   ``torch.sparse.mm``.  The dequantization (uint8 and uint16) with its
   constants and output made once: its own device time a launch from a
   ``torch.profiler`` trace (a CUDA graph's replay where the trace holds
   no device time), the CUDA-event time of its calls, and the same with
   the constants and output made in each call (the reading of earlier
   runs), beside ``torch.addcmul``, Eq. 2 in one call.  Every kernel row
   also logs ``host_ms``, the host's time a call.

The last two lines of standard output are the ``{"kernels": [...]}`` line
and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import functools
import inspect
import json
import re
import statistics
import subprocess
import sys
import threading
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
#: H100 SXM dense bfloat16 tensor-core rate (data sheet), FLOP/s.
BF16_FLOP_PER_S = 989e12

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
    the shapes of the reference's tests/test_kernels.py; then with
    per-segment constants (``[S]`` tables): S in {1, 3, 4} segments whose
    lengths are and are not whole 16-element vectors, q as it is and 1 or
    4 elements off its vector grid, an ``out=`` slice 1 element off, an
    empty matrix, u8 and u16, each also equal to one call a segment."""
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

    def shifted(q, k):
        return torch.empty(q.numel() + k, dtype=q.dtype, device=device)[
            k:].view(q.shape).copy_(q)

    rng = np.random.default_rng(5)
    for rows, feat, segs in ((12, 128, 1), (12, 128, 3), (12, 128, 4),
                             (36, 7, 3), (4004, 33, 4), (3003, 128, 3),
                             (0, 16, 4)):
        for bits, dtype in ((8, torch.uint8), (16, torch.uint16)):
            q = torch.empty((0, feat), dtype=dtype, device=device)
            if rows:
                q = P.quantize(torch.from_numpy(rng.normal(size=(
                    rows, feat)).astype(np.float32)).to(device), bits).q
            scale = torch.from_numpy(rng.uniform(0.01, 1.0, segs).astype(
                np.float32)).to(device)
            x_min = torch.from_numpy(rng.normal(size=segs).astype(
                np.float32)).to(device)
            want = P.dequant_mod.dequantize_plain(q, scale, x_min)
            big = torch.full((rows * feat + 3,), float("nan"),
                             device=device)
            n = rows // segs
            gots = [P.ops.dequantize(src, scale, x_min, bits=bits, out=out)
                    for src, out in ((q, None), (shifted(q, 1), None),
                                     (shifted(q, 4), None),
                                     (shifted(q, 1),
                                      big[1:-2].view(q.shape)))]
            gots.append(torch.cat([
                P.ops.dequantize(q[s * n:(s + 1) * n], scale[s], x_min[s],
                                 bits=bits) for s in range(segs)]))
            if not (all(torch.equal(g, want) for g in gots)
                    and bool(big[0].isnan()) and bool(big[-2:].isnan().all())):
                raise AssertionError(f"dequantize differs on {rows} x {feat}"
                                     f" in {segs} segments, bits={bits}")
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
# phase 4, last: incremental plan maintenance
# ---------------------------------------------------------------------------

#: the ``window`` delta's deletions and additions, on two adjacent blocks
WINDOW_EDGES = 128
#: the ``churn_1pct`` delta (benchmarks/incremental_update.py's regime):
#: this share of the edges, half deleted and half added, on this share of
#: the rows, drawn with probability proportional to (deg + 1)^2
CHURN_FRAC = 0.01
CHURN_ACTIVE_FRAC = 0.02
#: feature rows the int8 plan's patch re-quantizes
REQUANT_ROWS = 64


def _delta(np, rng, keys, n, cand_keys, k, draw_rows):
    """``k`` deletions drawn from ``cand_keys`` (unique present keys) and
    ``k`` additions: rows from ``draw_rows(size)``, columns uniform,
    rejected where present, deleted or drawn before."""
    dels = rng.choice(cand_keys, size=min(k, cand_keys.size), replace=False)
    adds = np.zeros(0, np.int64)
    while adds.size < k:
        size = 32 * (k - adds.size) + 64     # hub rows reject most draws
        new = draw_rows(size) * n + rng.integers(0, n, size)
        pos = np.minimum(np.searchsorted(keys, new), keys.size - 1)
        new = new[(keys[pos] != new) & ~np.isin(new, dels)]
        new = np.concatenate([adds, new])
        _, first = np.unique(new, return_index=True)
        adds = new[np.sort(first)][:k]
    return ([(int(a // n), int(a % n)) for a in adds],
            [(int(d // n), int(d % n)) for d in dels])


def make_deltas(P, adj, block_rows, seed=0) -> dict:
    """The ``window`` and ``churn_1pct`` deltas, drawn with numpy from
    ``seed`` (vectorized: the reference's ``make_delta`` walks a Python set
    of every edge)."""
    np = P.np
    rng = np.random.default_rng(seed)
    n = adj.num_rows
    rp = adj.row_ptr.cpu().numpy().astype(np.int64)
    # sorted unique row * n + col keys of the present edges
    keys = np.unique(np.repeat(np.arange(n), np.diff(rp)) * n
                     + adj.col_ind.cpu().numpy())
    # window: two adjacent full blocks
    b = int(rng.integers(0, n // block_rows - 1))
    r0, r1 = b * block_rows, (b + 2) * block_rows
    window = _delta(np, rng, keys, n, keys[(keys >= r0 * n) & (keys < r1 * n)],
                    WINDOW_EDGES, lambda size: rng.integers(r0, r1, size))
    # churn: an active row set drawn by (deg + 1)^2
    deg = np.diff(rp).astype(np.float64)
    p = (deg + 1.0) ** 2 / ((deg + 1.0) ** 2).sum()
    active = rng.choice(n, size=max(int(n * CHURN_ACTIVE_FRAC), 2),
                        replace=False, p=p)
    is_active = np.zeros(n, bool)
    is_active[active] = True
    p_active = p[active] / p[active].sum()
    churn = _delta(np, rng, keys, n, keys[is_active[keys // n]],
                   max(int(adj.nnz * CHURN_FRAC / 2), 1),
                   lambda size: rng.choice(active, size=size, p=p_active))
    return {"window": window, "churn_1pct": churn}


def _changed_features(P, x, seed=0):
    """(features with ``REQUANT_ROWS`` rows replaced by copies of other
    rows, the replaced rows): the rows holding the global min or max are
    kept, so every value stays inside the stored quantization range and
    the range itself does not move."""
    torch, np = P.torch, P.np
    rng = np.random.default_rng(seed)
    extreme = ((x == x.max()) | (x == x.min())).any(dim=1).cpu().numpy()
    rows = rng.choice(np.flatnonzero(~extreme), size=2 * REQUANT_ROWS,
                      replace=False)
    x2 = x.clone()
    dst = torch.from_numpy(rows[:REQUANT_ROWS]).to(x.device)
    x2[dst] = x[torch.from_numpy(rows[REQUANT_ROWS:]).to(x.device)]
    return x2, sorted(int(r) for r in rows[:REQUANT_ROWS])


def _median_s(torch, fn, setup=None, reps=3):
    """Host seconds of ``fn(setup())`` with the card synchronized around
    it: one untimed round, then the median of ``reps``; returns (s, the
    last result).  ``setup`` runs outside the timer."""
    times, out = [], None
    for i in range(reps + 1):
        arg = setup() if setup is not None else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(arg)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def _same_plan(torch, got, want) -> bool:
    return (got.fingerprint == want.fingerprint
            and got.block_digests == want.block_digests
            and got.bell.widths == want.bell.widths
            and got.bell.strategies == want.bell.strategies
            and got.buckets == want.buckets
            and all(torch.equal(getattr(got.bell, f), getattr(want.bell, f))
                    for f in ("val", "col", "live_w")))


def incremental_path(P, ds) -> dict:
    """Patch three blocked plans of reddit's ``gcn_adj`` (natural f32,
    natural int8 with ``REQUANT_ROWS`` changed feature rows, degree-sorted
    f32; ``tune_blocked``'s defaults with measurement off) for two deltas,
    and hold each patch against a cold tune of the patched graph: plan
    parity, a plan-cache hit served through ``block_ell_spmm``, outputs
    against the cold plan and the ``torch`` twin, and the merge on the card
    against the CPU.  Times the patch, ``apply_csr_deltas``, its delta
    parse, the hash of the touched digest blocks and the cold tune, each
    alone (the last two on fresh copies of the CSR, so the digest memo
    misses).  Returns the launches of the run (counts set to 0 at its
    start), less those of the cold plans run for comparison."""
    torch = P.torch
    adj, x = ds.gcn_adj, ds.features
    kw = dict(refresh=True, measure_plan=False, measure_buckets=False)
    block_rows = inspect.signature(P.tune_blocked).parameters[
        "block_rows"].default
    deltas = make_deltas(P, adj, block_rows)
    x2, requant = _changed_features(P, x)
    cpu_adj = adj.to("cpu")
    cpu_merge = {name: P.apply_csr_deltas(cpu_adj, *d)
                 for name, d in deltas.items()}
    failures, compared = [], {}
    t_phase = time.perf_counter()
    P.ops.reset_launch_counts()                   # the path starts here
    for pname, tkw, feats, rows in (
            ("natural_f32", {}, x, ()),
            ("natural_int8", {"quant": 8}, x2, requant),
            ("degree_sorted_f32", {"layout": "degree_sorted"}, x, ())):
        base = P.tune_blocked(adj, x, cache=P.PlanCache(), **kw, **tkw)
        for dname, (adds, dels) in deltas.items():
            cache = P.PlanCache()
            patch_s, (patched, new_csr, report) = _median_s(
                torch, lambda _: P.apply_edge_updates(
                    base, adj, adds, dels, features=feats,
                    requant_rows=rows, cache=cache))
            merge_s, (_, touched) = _median_s(
                torch, lambda _: P.apply_csr_deltas(adj, adds, dels))
            # the host parse of the delta lists, and the patch's host hash
            # of the touched digest blocks, each alone
            parse_s, _ = _median_s(
                torch, lambda _: (P.graph_mod._parse_deltas(adds, "a"),
                                  P.graph_mod._parse_deltas(dels, "d")))
            digest_s, _ = _median_s(
                torch, lambda c: P.csr_block_digests(
                    c, blocks=report.touched_digest_blocks),
                setup=lambda: P.CSR(*(t.clone() for t in new_csr[:3]),
                                    new_csr.num_cols))
            cold_s, cold = _median_s(
                torch, lambda c: P.tune_blocked(c, feats, cache=P.PlanCache(),
                                                **kw, **tkw),
                setup=lambda: P.CSR(*(t.clone() for t in new_csr[:3]),
                                    new_csr.num_cols))
            # the merge on the card against the CPU
            want_csr, want_touched = cpu_merge[dname]
            merge_ok = new_csr.device.type == "cuda" and all(
                torch.equal(a.cpu(), b)
                for a, b in zip(new_csr[:3], want_csr[:3])) and \
                P.np.array_equal(touched, want_touched)
            # plan parity with the cold tune
            if "layout" in tkw:
                parity = patched.fingerprint == cold.fingerprint
            else:
                parity = _same_plan(torch, patched, cold) and (
                    patched.quantized is None or torch.equal(
                        patched.quantized.q, cold.quantized.q))
            # the patched plan served from the cache
            P.obs.reset()
            before = P.ops.launch_counts()
            out = P.aes_spmm(new_csr, feats, strategy="auto",
                             granularity="block", plan_cache=cache,
                             tune_kwargs={"layout": tkw["layout"]}
                             if "layout" in tkw else None)
            torch.cuda.synchronize()
            served = P.ops.launch_counts()["block_ell_spmm"] - \
                before["block_ell_spmm"]
            counters = P.obs.default_registry().counters("plan_cache.")
            spans = {sp.name for sp in P.obs.default_tracer().spans()}
            hit = ("tune.decision" not in spans
                   and counters.get("plan_cache.hit_memory", 0) >= 1
                   and counters.get("plan_cache.miss", 0) == 0
                   and len(cache) == 1 and cache.plans()[0].version == 1)
            twin = _torch_twin(P, patched).run(feats)
            twin_err = float((out - twin).abs().max())
            cold_err = None
            if "layout" not in tkw:
                before = P.ops.launch_counts()
                cold_err = float((out - cold.run(feats)).abs().max())
                for k, n in P.ops.launch_counts().items():
                    compared[k] = compared.get(k, 0) + n - before[k]
            # the u8 gather's tolerance; f32 rounds as its plain version
            twin_tol = 1e-4 if "quant" in tkw else 0.0
            ok = (merge_ok and parity and hit and served >= 1
                  and twin_err <= twin_tol and cold_err in (None, 0.0)
                  and out.shape == (adj.num_rows, x.shape[1])
                  and bool(torch.isfinite(out).all()))
            log({"phase": "incremental", "plan": pname, "delta": dname,
                 "additions": len(adds), "deletions": len(dels),
                 "touched_rows": report.touched_rows,
                 "touched_blocks": len(report.touched_blocks),
                 "num_blocks": report.num_blocks,
                 "touched_digest_blocks": len(report.touched_digest_blocks),
                 "requantized_rows": report.requantized_rows,
                 "edges_after": new_csr.nnz,
                 "widths": {str(w): patched.bell.widths.count(w)
                            for w in sorted(set(patched.bell.widths))},
                 "patch_s": patch_s, "apply_csr_deltas_s": merge_s,
                 "parse_s": parse_s, "touched_digest_s": digest_s,
                 "cold_tune_s": cold_s, "speedup": cold_s / patch_s,
                 "plan_parity": parity, "cache_hit": hit,
                 "served_block_ell_spmm_launches": served,
                 "vs_cold_max_abs_err": cold_err,
                 "vs_torch_twin_max_abs_err": twin_err,
                 "merge_equals_cpu": merge_ok, "ok": ok})
            if not ok:
                failures.append(f"{pname}/{dname}")
    launches = {k: n - compared.get(k, 0)         # ... and ends here
                for k, n in P.ops.launch_counts().items()}
    log({"phase": "incremental_launches", "launches": launches,
         "comparison_launches": compared,
         "wall_s": time.perf_counter() - t_phase})
    if failures:
        raise AssertionError(f"incremental: {failures} failed (the "
                             "incremental lines above say which check)")
    return launches


# ---------------------------------------------------------------------------
# phase 4, last: sharded serving
# ---------------------------------------------------------------------------

#: row shards of the serving phase: all four share the one card
SERVING_SHARDS = 4
#: F of the dense requests (the GCN's hidden width on reddit)
SERVING_DENSE_F = 64
#: distinct dense operands the open-loop requests cycle through
SERVING_POOL = 8
#: open-loop requests per offered rate, half resident, half dense
SERVING_REQUESTS = 64
#: offered rates, as multiples of the synchronous baseline's
SERVING_RATES = (0.5, 1.0, 2.0, 4.0)
#: the runtime's batch size, deadline and queue bound at full size: a
#: batch of 8 holds at most 4 dense operands (256 columns, ~240 MB a
#: gathered shard operand), so the phase stays far inside 80 GB
SERVING_MAX_BATCH, SERVING_MAX_DELAY_MS, SERVING_QUEUE_DEPTH = 8, 2.0, 32


def _uncounted(P, compared: dict, fn):
    """``fn()``, its launches added to ``compared``, which a path leaves out
    of its own count: they compare or time, they do not serve."""
    before = P.ops.launch_counts()
    out = fn()
    P.torch.cuda.synchronize()
    for k, v in P.ops.launch_counts().items():
        compared[k] = compared.get(k, 0) + v - before[k]
    return out


def _torch_twins_of(P, server, x):
    """``server``'s shard plans run one by one on ``x`` (None: the resident
    operands) through their ``torch`` twins (the blocked kernel's plain
    computation), concatenated on the server's device: what ``aggregate``
    must equal.  Each shard runs on its own device, as the server runs it
    (on several cards, round robin)."""
    outs = []
    for s, shard in enumerate(server.shards):
        plan = server.plans[s] if x is None else server._float_plans[s]
        op = server._resident[s] if x is None \
            else shard.gather(x).to(server._devices[s])
        out = _torch_twin(P, plan).run(op, assume_tuned=x is None)
        outs.append(out.to(server.device))
    return P.torch.cat(outs, dim=0)


def _global_edges(P, shards) -> tuple:
    """The (row, col, val) edges of CSR shards (or of one whole CSR), in
    global ids, sorted: a key that ignores the order within a row."""
    np = P.np
    rows, cols, vals = [], [], []
    for sh in shards:
        csr = getattr(sh, "csr", sh)
        r0 = getattr(sh, "row_start", 0)
        index = getattr(sh, "gather_index", None)
        rp = csr.row_ptr.cpu().numpy()
        ci = csr.col_ind.cpu().numpy().astype(np.int64)
        rows.append(r0 + np.repeat(np.arange(csr.num_rows), np.diff(rp)))
        cols.append(ci if index is None else index[ci])
        vals.append(csr.val.cpu().numpy())
    rows, cols, vals = (np.concatenate(a) for a in (rows, cols, vals))
    order = np.lexsort((vals, cols, rows))
    return tuple(a[order].tobytes() for a in (rows, cols, vals))


def _dispatch_vs_completion(P, server, batch, reps=5) -> dict:
    """Host ms ``run_batch`` takes to return (under PyTorch's sync debug
    mode "error": no operation in it may wait for the card) beside the ms
    until a CUDA event recorded after it completes; medians of ``reps``."""
    torch = P.torch
    dispatch, complete = [], []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            server.run_batch(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        t1 = time.perf_counter()
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
        t2 = time.perf_counter()
        dispatch.append((t1 - t0) * 1e3)
        complete.append((t2 - t0) * 1e3)
    d, c = statistics.median(dispatch[1:]), statistics.median(complete[1:])
    return {"dispatch_ms": d, "complete_ms": c, "ratio": d / c}


def _host_split(P, server, rounds=3) -> dict:
    """Host ms of one resident pass, layer by layer: the blocked kernel's
    wrapper and the executor on shard 0's plan — as it runs, with obs off,
    and with the interpreter's cyclic garbage collector off — and
    ``run_batch`` (all shards); each the median of ``rounds`` readings
    taken in turns, beside the objects the collector tracks."""
    import gc

    torch = P.torch
    plan0, op0 = server.plans[0], server._resident[0]
    executor = P.PlanExecutor()

    def run_plan():
        return executor.run_plan(plan0, op0, assume_tuned=True)

    def run_plan_obs_off():
        prev = P.obs.set_enabled(False)
        try:
            return run_plan()
        finally:
            P.obs.set_enabled(prev)

    def run_plan_gc_off():
        gc.disable()
        try:
            return run_plan()
        finally:
            gc.enable()

    calls = {"block_ell_spmm_wrapper": lambda: P.ops.block_ell_spmm(
                 plan0.bell, op0, buckets=plan0.buckets),
             "run_plan": run_plan, "run_plan_obs_off": run_plan_obs_off,
             "run_plan_gc_off": run_plan_gc_off,
             "run_batch_all_shards": lambda: server.run_batch([None])}
    readings = {k: [] for k in calls}
    for _ in range(rounds):
        for k, fn in calls.items():
            readings[k].append(host_ms(torch, fn))
    out = {k: statistics.median(v) for k, v in readings.items()}
    out["gc_tracked_objects"] = len(gc.get_objects())
    return out


def _event_wait_releases_gil(P) -> dict:
    """Whether ``torch.cuda.Event.synchronize`` lets other Python threads
    run while it waits (the runtime's completer waits so while the batcher
    assembles the next batch): a thread waits for ~0.3 s of matmuls while
    this one counts loop iterations for 0.1 s, against the same count with
    no waiter."""
    torch = P.torch
    a = torch.randn((8192, 8192), device="cuda")

    def spin(seconds):
        n, end = 0, time.perf_counter() + seconds
        while time.perf_counter() < end:
            n += 1
        return n

    base = spin(0.1)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        for _ in range(20):
            a = a @ a / 90.5           # ~sqrt(8192): entries stay ~N(0, 1)
        ev = torch.cuda.Event()
        ev.record(stream)
    waiter = threading.Thread(target=ev.synchronize)
    waiter.start()
    time.sleep(0.005)
    during = spin(0.1)
    pending = not ev.query()
    waiter.join(60)
    return {"spin_iters_alone": base, "spin_iters_while_waiting": during,
            "event_pending_after_spin": pending,
            "released": pending and during > 0.5 * base}


def _runtime_line(P, server, rate, pool, expected) -> dict:
    """One open-loop run at ``rate``: every completed result held against
    the synchronous result for its operand; returns the line's numbers."""
    torch = P.torch
    dispatch = []
    run_batch = server.run_batch

    def timed_run_batch(batch):
        t0 = time.perf_counter()
        out = run_batch(batch)
        dispatch.append(time.perf_counter() - t0)
        return out

    server.run_batch = timed_run_batch
    reqs = []
    rt = P.ServingRuntime(server, max_batch=SERVING_MAX_BATCH,
                          max_delay_ms=SERVING_MAX_DELAY_MS,
                          queue_depth=SERVING_QUEUE_DEPTH, policy="reject")
    submit = rt.submit

    def kept_submit(x=None, timeout=None):
        r = submit(x, timeout)
        reqs.append((x, r))
        return r

    rt.submit = kept_submit
    try:
        res = P.run_open_loop(
            rt, rate_rps=rate, num_requests=SERVING_REQUESTS, seed=0,
            operand=lambda i: None if i % 2 == 0
            else pool[(i // 2) % SERVING_POOL])
        snap = rt.snapshot()
    finally:
        rt.close()
        del server.run_batch
    wrong = 0
    for x, r in reqs:
        if r.ok():
            want = expected[None if x is None else id(x)]
            wrong += not torch.equal(r.result(0), want)
    lat = snap["latency"]
    device_ms = [r.latency_us()["device"] / 1e3 for _, r in reqs if r.ok()]
    return {
        **{k: res[k] for k in ("offered_rps", "achieved_rps", "submitted",
                               "completed", "failed", "rejected", "wall_s",
                               "rows_per_s", "batches", "p50_ms", "p95_ms",
                               "p99_ms", "max_ms")},
        **{f"{stage}_p{p}_ms": lat[stage][f"p{p}_us"] / 1e3
           for stage in ("queue", "device") for p in (50, 95, 99)},
        "batch_triggers": {k: snap["counters"][f"batches_{k}"]
                           for k in ("size", "deadline", "drain")},
        "mean_batch_size": snap["mean_batch_size"],
        "queue_peak": snap["counters"]["queue_peak"],
        "dispatch_mean_ms": statistics.fmean(dispatch) * 1e3,
        "device_stage_mean_ms": statistics.fmean(device_ms),
        "dispatch_to_completion": statistics.fmean(dispatch) * 1e3
        / statistics.fmean(device_ms),
        "results_unequal_to_sync": wrong,
    }


def serving_path(P, ds, modules, full_acc, cache_root: Path) -> dict:
    """Sharded serving on the card over reddit's ``gcn_adj``: a 4-shard
    ``GNNServer`` (loop mode, ``tune_blocked``'s defaults; f32 and int8,
    each on a fresh disk ``PlanCache`` under ``cache_root``) held against
    its plans' ``torch`` twins, the warm restart, the synchronous baseline
    and the open-loop runtime sweep, ``evaluate(strategy="auto",
    shards=4)`` for the trained models, and an edge update.  Returns the
    launches of the run (counts set to 0 at its start), less those made
    only to compare."""
    torch = P.torch
    adj, x = ds.gcn_adj, ds.features
    n = adj.num_rows
    gen = torch.Generator(device=adj.device).manual_seed(0)
    dense = torch.randn((n, SERVING_DENSE_F), generator=gen,
                        device=adj.device)
    failures, compared = [], {}
    comparing = functools.partial(_uncounted, P, compared)

    def check(ok, what):
        if not ok:
            failures.append(what)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    P.ops.reset_launch_counts()                   # the path starts here
    servers, tune_s = {}, {}
    for name, quant in (("f32", None), ("int8", 8)):
        cache_dir = str(cache_root / name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server = P.GNNServer(adj, x, num_shards=SERVING_SHARDS, quant=quant,
                             cache=P.PlanCache(cache_dir))
        torch.cuda.synchronize()
        tune_s[name] = time.perf_counter() - t0
        servers[name] = server
        tol = 1e-4 if quant else 0.0      # the u8 gather's tolerance
        errs = {}
        for label, op in (("resident", None), ("dense_f64", dense)):
            got = server.aggregate(op)
            want = comparing(lambda: _torch_twins_of(P, server, op))
            errs[label] = float((got - want).abs().max())
            check(got.shape == (n, x.shape[1] if op is None
                                else SERVING_DENSE_F)
                  and bool(torch.isfinite(got).all())
                  and errs[label] <= tol, f"parity {name} {label}")
        # a micro-batch of two float operands equals the one-shot results
        t_a, t_b = server.submit(dense), server.submit(dense * 2.0)
        batch = server.flush()
        micro_err = max(
            float((batch[t_a] - server.aggregate(dense)).abs().max()),
            float((batch[t_b] - server.aggregate(dense * 2.0)).abs().max()))
        check(micro_err == 0.0, f"micro-batch {name}")
        plans = server.plan_summary()
        log({"phase": "serving_parity", "plans": name,
             "tune_s": tune_s[name],
             "halo": server.halo_stats(),
             "plan_summary": [
                 {"shard": p["shard"], "rows": p["rows"], "halo": p["halo"],
                  "blocks": p["blocks"], "buckets": p["buckets"],
                  "widths": {str(w): p["widths"].count(w)
                             for w in sorted(set(p["widths"]))},
                  "quant_bits": p["quant_bits"]} for p in plans],
             "resident_on_uint8": [r is None for r in server._resident],
             "vs_torch_twin_max_abs_err": errs,
             "micro_batch_vs_one_shot_max_abs_err": micro_err,
             "tolerance": tol})
    # the init-time verification of the int8 server, timed alone: one host
    # hash of each shard's gathered features (as at init and after an edge
    # update), beside the digest and hash costs of the tuned path
    q_server = servers["int8"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    q_server._prepare_execution()
    prepare_s = time.perf_counter() - t0
    hash_s = []
    for shard in q_server.shards:
        g = shard.gather(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        P.features_fingerprint(g)
        hash_s.append(time.perf_counter() - t0)
    log({"phase": "serving_host_costs", "prepare_execution_s": prepare_s,
         "shard_hash_s": hash_s,
         "shard_bytes": [s.gather_index.size * x.shape[1] * 4
                         for s in q_server.shards]})

    # warm restart: a fresh cache on the f32 directory re-tunes nothing
    warm = P.PlanCache(str(cache_root / "f32"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restarted = P.GNNServer(adj, x, num_shards=SERVING_SHARDS, cache=warm)
    torch.cuda.synchronize()
    restart_s = time.perf_counter() - t0
    same = torch.equal(restarted.aggregate(), servers["f32"].aggregate())
    log({"phase": "serving_warm_restart", "restart_s": restart_s,
         "first_tune_s": tune_s["f32"], "disk_hits": warm.stats.disk_hits,
         "misses": warm.stats.misses, "output_equal": same})
    check(warm.stats.disk_hits == SERVING_SHARDS and warm.stats.misses == 0
          and same, "warm restart")
    del restarted

    # the synchronous baseline, then the open loop at multiples of its rate
    server = servers["f32"]
    base = P.sync_baseline(server, iters=16, warmup=2)
    # a batch whose device work outweighs its dispatch shows whether
    # run_batch waits for the card: 8 dense operands, 512 columns
    split = comparing(lambda: {
        "resident": _dispatch_vs_completion(P, server, [None]),
        "dense_x2": _dispatch_vs_completion(P, server, [dense] * 2),
        "dense_x8": _dispatch_vs_completion(P, server, [dense] * 8)})
    host = comparing(lambda: _host_split(P, server))
    log({"phase": "serving_sync_baseline", **base,
         "dispatch_vs_completion": split, "host_ms_per_call": host,
         "event_wait": _event_wait_releases_gil(P)})
    pool = [torch.randn((n, SERVING_DENSE_F), generator=gen,
                        device=adj.device) for _ in range(SERVING_POOL)]
    expected = {None: server.aggregate()}
    expected.update({id(op): server.aggregate(op) for op in pool})
    for rx in SERVING_RATES:
        line = _runtime_line(P, server, base["rps"] * rx, pool, expected)
        log({"phase": "serving_runtime", "rate_x_baseline": rx,
             "max_batch": SERVING_MAX_BATCH,
             "max_delay_ms": SERVING_MAX_DELAY_MS,
             "queue_depth": SERVING_QUEUE_DEPTH, **line})
        check(line["results_unequal_to_sync"] == 0
              and line["completed"] >= 1 and line["failed"] == 0,
              f"runtime at {rx}x")
    del pool, expected

    # evaluate(shards=4) with the trained models, beside the single-device
    # tuned path and the same sharded call on the plans' torch twins
    for model in ("gcn", "graphsage"):
        params = modules[model]
        walls, accs = {}, {}
        for key, kw in (("sharded", dict(shards=SERVING_SHARDS)),
                        ("single_device", {}),
                        ("sharded_torch_twin",
                         dict(shards=SERVING_SHARDS,
                              tune_kwargs={"backend": "torch"}))):
            call = functools.partial(P.evaluate, ds, model, params,
                                     strategy="auto", plan_cache=P.PlanCache(),
                                     **kw)
            t0 = time.perf_counter()
            accs[key] = call() if key == "sharded" else comparing(call)
            walls[key] = time.perf_counter() - t0
        log({"phase": "serving_sharded_evaluate", "model": model,
             "shards": SERVING_SHARDS, "accuracy": accs["sharded"],
             "accuracy_lost_vs_full": full_acc[model] - accs["sharded"],
             "single_device_accuracy": accs["single_device"],
             "torch_twin_accuracy": accs["sharded_torch_twin"],
             "cold_wall_s": walls})
        check(abs(accs["sharded"] - accs["sharded_torch_twin"]) <= 1e-3
              and 0.0 <= accs["sharded"] <= 1.0, f"sharded evaluate {model}")

    # an edge update on the f32 server.  A touched row's edges are re-sorted
    # by their shard-local column ids (as in the reference package), which
    # put the shard's own rows before its halo, so its edge order, and what
    # AES keeps of it, can differ from a fresh partition of the patched
    # graph.  So the server is held to (1) the CPU merge's edges and (2) a
    # cold tune of each patched shard, output for output.
    block_rows = inspect.signature(P.tune_blocked).parameters[
        "block_rows"].default
    adds, dels = make_deltas(P, adj, block_rows)["window"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = server.apply_edge_updates(adds, dels)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    got = server.aggregate()
    merged, _ = P.apply_csr_deltas(adj.to("cpu"), adds, dels)
    edges_ok = _global_edges(P, server.shards) == _global_edges(P, [merged])
    touched = report["patched"] + report["retuned"]

    def cold_outputs():
        # a cold tune runs where the shard's CSR lives, a kept plan on its
        # shard's device (on several cards, round robin)
        outs = []
        for i, shard in enumerate(server.shards):
            op = shard.gather(x)
            plan = server.plans[i]
            if i in touched:
                cold = P.tune_blocked(shard.csr, op, cache=P.PlanCache(),
                                      shard_meta=plan.shard_meta)
                if cold.fingerprint != plan.fingerprint:
                    return None
                out = cold.run(op)
            else:
                out = plan.run(op.to(server._devices[i]))
            outs.append(out.to(server.device))
        return torch.cat(outs, dim=0)

    want = comparing(cold_outputs)
    update_err = None if want is None else float((got - want).abs().max())
    log({"phase": "serving_edge_update", "additions": len(adds),
         "deletions": len(dels),
         **{k: report[k] for k in ("patched", "retuned", "untouched",
                                   "halo_shrunk")},
         "apply_edge_updates_s": update_s,
         "edges_equal_cpu_merge": edges_ok,
         "vs_cold_shard_plans_max_abs_err": update_err})
    check(edges_ok and update_err == 0.0 and bool(touched), "edge update")
    launches = {k: v - compared.get(k, 0)         # ... and ends here
                for k, v in P.ops.launch_counts().items()}
    log({"phase": "serving_launches", "launches": launches,
         "comparison_and_timing_launches": compared,
         "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
         "wall_s": time.perf_counter() - t_phase})
    del servers, server
    if failures:
        raise AssertionError(f"serving: {failures} failed (the serving "
                             "lines above say which check)")
    if launches["block_ell_spmm"] <= 0:
        raise AssertionError("kernel block_ell_spmm was not launched on "
                             "the serving path")
    return launches


# ---------------------------------------------------------------------------
# phase 4: sharded serving in spmd mode, then the command lines
# ---------------------------------------------------------------------------

#: the most width buckets, so blocked launches, of one spmd pass
SPMD_MAX_BUCKETS = 3
#: cycles the card spins before a timed batch of passes, so that the host
#: has queued the whole batch before the first pass starts (~0.1 s)
QUEUE_AHEAD_CYCLES = 200_000_000


def queued_device_ms(torch, fn, batch=TIMING_BATCH,
                     reps=TIMING_REPS, cards=()) -> float:
    """Device time of one call, in ms, for calls whose host time exceeds
    their device time (a serving pass): the card spins first, the host
    queues ``batch`` calls behind the spin between one pair of CUDA events,
    so the events time the device work alone; the median of ``reps``.
    ``cards``: the other cards a call runs on, each spun too (the events
    lie on the current card, where a call's output is gathered)."""
    fn()
    times = []
    for _ in range(reps):
        for card in cards:
            torch.cuda.synchronize(card)
        torch.cuda.synchronize()
        for card in cards:
            with torch.cuda.device(card):
                torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
        torch.cuda._sleep(QUEUE_AHEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        queued = not start.query()        # the spin outlasted the queueing
        end.synchronize()
        if not queued:
            raise AssertionError("the host queued the batch slower than the "
                                 "card spun: raise QUEUE_AHEAD_CYCLES")
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def serving_spmd_path(P, ds, cache_root: Path) -> dict:
    """``GNNServer(mode="spmd")`` on the card over reddit's ``gcn_adj``: 4
    shards stacked on the card, f32 and int8, each built on a fresh disk
    ``PlanCache`` over the loop servers' directory under ``cache_root`` (4
    disk hits, so the plans the serving phase tuned), held bit for bit
    against a loop server on the same plans (resident and a dense F = 64
    operand); the launches of one pass; a pass's device and host ms beside
    loop mode's; ``ServingRuntime`` at the synchronous baseline's rps with
    every result equal to the synchronous one (f32); a ``window`` edge
    update equal to loop mode's after the same update (f32); a
    degree-sorted plan refused.  Returns the launches of the run (counts
    set to 0 at its start), less those made only to compare or time."""
    torch = P.torch
    adj, x = ds.gcn_adj, ds.features
    n = adj.num_rows
    gen = torch.Generator(device=adj.device).manual_seed(1)
    dense = torch.randn((n, SERVING_DENSE_F), generator=gen,
                        device=adj.device)
    failures, compared = [], {}
    comparing = functools.partial(_uncounted, P, compared)

    def check(ok, what):
        if not ok:
            failures.append(what)

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    P.ops.reset_launch_counts()                   # the path starts here
    for name, quant in (("f32", None), ("int8", 8)):
        cache_dir = str(cache_root / name)
        cache = P.PlanCache(cache_dir)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spmd = P.GNNServer(adj, x, num_shards=SERVING_SHARDS, mode="spmd",
                           quant=quant, cache=cache, devices=["cuda:0"],
                           max_buckets=SPMD_MAX_BUCKETS)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        loop_cache = P.PlanCache(cache_dir)
        loop = comparing(lambda: P.GNNServer(
            adj, x, num_shards=SERVING_SHARDS, quant=quant,
            cache=loop_cache))
        bundle = spmd._bundles[0]
        check(cache.stats.disk_hits == loop_cache.stats.disk_hits
              == SERVING_SHARDS and cache.stats.misses == 0
              and loop_cache.stats.misses == 0, f"same plans {name}")
        check(bundle._quant == (quant is not None), f"resident {name}")
        equal, errs, per_pass = {}, {}, {}
        for label, op in (("resident", None), ("dense_f64", dense)):
            got = spmd.aggregate(op)
            want = comparing(lambda: loop.aggregate(op))
            equal[label] = bool(torch.equal(got, want))
            errs[label] = float((got - want).abs().max())
            check(equal[label] and bool(torch.isfinite(got).all()),
                  f"spmd vs loop {name} {label}")
            per_pass[label] = _pass_launches(P, spmd, op)
            block = per_pass[label].get("block_ell_spmm", 0)
            deq = per_pass[label].get("dequantize", 0)
            check(1 <= block <= SPMD_MAX_BUCKETS
                  and deq == (1 if quant and op is None else 0),
                  f"launches a pass {name} {label}")
        loop_per_pass = comparing(lambda: _pass_launches(P, loop))
        times = comparing(lambda: {
            mode: {label: {"device_ms": queued_device_ms(
                               torch, lambda: srv.run_batch([op])),
                           "host_ms": host_ms(
                               torch, lambda: srv.run_batch([op]))}
                   for label, op in (("resident", None),
                                     ("dense_f64", dense))}
            for mode, srv in (("spmd", spmd), ("loop", loop))})
        dispatch = comparing(
            lambda: _dispatch_vs_completion(P, spmd, [None]))
        deq_line = comparing(lambda: _spmd_dequantize(P, bundle)) \
            if quant else None
        log({"phase": "serving_spmd", "plans": name,
             "build_s": build_s, "disk_hits": cache.stats.disk_hits,
             "buckets": [[w, len(ids)] for w, ids in bundle.buckets],
             "stacked_blocks": bundle.bell.num_blocks,
             "stacked_rows": bundle.bell.num_rows,
             "operand_rows": bundle.gcap * SERVING_SHARDS,
             "resident_uint8": bundle._quant,
             "equal_to_loop": equal, "vs_loop_max_abs_err": errs,
             "launches_a_pass": per_pass,
             "loop_launches_a_pass": loop_per_pass,
             "pass_ms": times, "dispatch_vs_completion": dispatch,
             "resident_dequantize": deq_line})

        if name == "f32":
            base = P.sync_baseline(spmd, iters=16, warmup=2)
            pool = [torch.randn((n, SERVING_DENSE_F), generator=gen,
                                device=adj.device)
                    for _ in range(SERVING_POOL)]
            expected = {None: spmd.aggregate()}
            expected.update({id(op): spmd.aggregate(op) for op in pool})
            line = _runtime_line(P, spmd, base["rps"], pool, expected)
            log({"phase": "serving_spmd_runtime", "sync_baseline": base,
                 "rate_x_baseline": 1.0, "max_batch": SERVING_MAX_BATCH,
                 "max_delay_ms": SERVING_MAX_DELAY_MS,
                 "queue_depth": SERVING_QUEUE_DEPTH, **line})
            check(line["results_unequal_to_sync"] == 0
                  and line["completed"] >= 1 and line["failed"] == 0,
                  "spmd runtime")
            del pool, expected

            # the same window delta on both servers
            block_rows = inspect.signature(P.tune_blocked).parameters[
                "block_rows"].default
            adds, dels = make_deltas(P, adj, block_rows)["window"]
            loop_report = comparing(
                lambda: loop.apply_edge_updates(adds, dels))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            report = spmd.apply_edge_updates(adds, dels)
            torch.cuda.synchronize()
            update_s = time.perf_counter() - t0
            upd_equal = {}
            for label, op in (("resident", None), ("dense_f64", dense)):
                got = spmd.aggregate(op)
                upd_equal[label] = bool(torch.equal(
                    got, comparing(lambda: loop.aggregate(op))))
            same_route = all(report[k] == loop_report[k] for k in
                             ("patched", "retuned", "untouched"))
            log({"phase": "serving_spmd_edge_update",
                 "additions": len(adds), "deletions": len(dels),
                 **{k: report[k] for k in ("patched", "retuned",
                                           "untouched", "halo_shrunk")},
                 "apply_edge_updates_s": update_s,
                 "same_routing_as_loop": same_route,
                 "equal_to_loop": upd_equal})
            check(same_route and all(upd_equal.values()),
                  "spmd edge update")
        del spmd, loop, bundle

    # a degree-sorted plan is refused, as in the reference package
    small = P.make_dataset("cora", scale=0.1, seed=0, device=adj.device)
    try:
        comparing(lambda: P.GNNServer(
            small.gcn_adj, small.features, num_shards=SERVING_SHARDS,
            mode="spmd", cache=P.PlanCache(),
            tune_kwargs={"layout": "degree_sorted", "measure_plan": False,
                         "measure_buckets": False}))
        refused = None
    except ValueError as exc:
        refused = str(exc)
    log({"phase": "serving_spmd_refusal", "degree_sorted": refused})
    check(refused is not None and "degree-sorted" in refused,
          "permuted plan refused")

    launches = {k: v - compared.get(k, 0)         # ... and ends here
                for k, v in P.ops.launch_counts().items()}
    log({"phase": "serving_spmd_launches", "launches": launches,
         "comparison_and_timing_launches": compared,
         "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
         "wall_s": time.perf_counter() - t_phase})
    if failures:
        raise AssertionError(f"serving_spmd: {failures} failed (the "
                             "serving_spmd lines above say which check)")
    for name in ("block_ell_spmm", "dequantize"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "spmd serving path")
    return launches


#: device slots of the one-card ``serving_spmd_slots`` lines: the 4 shards
#: split over 2 and over 4 stacks on ``cuda:0``
SPMD_SLOTS = (2, 4)


def serving_spmd_slots_path(P, ds, cache_root: Path) -> dict:
    """``GNNServer(mode="spmd")`` over several device slots on reddit's
    ``gcn_adj``, 4 shards, f32 and int8, every server on a fresh disk
    ``PlanCache`` over the loop servers' directory under ``cache_root`` (4
    disk hits, no tune): ``devices=["cuda:0"] * k`` for k in
    :data:`SPMD_SLOTS` (a ``serving_spmd_slots`` line each) and, with more
    than one card, one slot a card (``serving_spmd_cards``).  Each is held
    bit for bit against a loop server and the one-slot server on the same
    plans (resident and a dense F = 64 operand), its output on ``cuda:0``;
    the launches of one pass (``block_ell_spmm`` once a non-empty global
    bucket a slot, at most slots x :data:`SPMD_MAX_BUCKETS`; int8 one
    ``dequantize`` a slot); a pass's device ms (every card it uses spun
    first) and host ms beside the one-slot pass's; ``run_batch``'s dispatch
    under the sync debug mode "error".  Across cards, f32 also a
    ``ServingRuntime`` burst at the synchronous baseline's rps, its results
    equal to ``flush()``'s: the copies between cards are ordered on both
    cards' streams.  Returns the launches of the run (counts set to 0 at
    its start), less those made only to compare or time."""
    torch = P.torch
    adj, x = ds.gcn_adj, ds.features
    n = adj.num_rows
    gen = torch.Generator(device=adj.device).manual_seed(2)
    dense = torch.randn((n, SERVING_DENSE_F), generator=gen,
                        device=adj.device)
    home = torch.device("cuda", 0)
    cards = torch.cuda.device_count()
    layouts = {f"slots_{k}": ["cuda:0"] * k for k in SPMD_SLOTS}
    if cards > 1:
        layouts["cards"] = [f"cuda:{i}"
                            for i in range(min(cards, SERVING_SHARDS))]
    failures, compared = [], {}
    comparing = functools.partial(_uncounted, P, compared)

    def check(ok, what):
        if not ok:
            failures.append(what)

    def timed(srv, devices):
        others = sorted({torch.device(d) for d in devices} - {home},
                        key=str)
        return {label: {"device_ms": queued_device_ms(
                            torch, lambda: srv.run_batch([op]),
                            cards=others),
                        "host_ms": host_ms(
                            torch, lambda: srv.run_batch([op]))}
                for label, op in (("resident", None), ("dense_f64", dense))}

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    P.ops.reset_launch_counts()                   # the path starts here
    lines = {name: {} for name in layouts}
    for plans, quant in (("f32", None), ("int8", 8)):
        cache_dir = str(cache_root / plans)

        def server(devices, mode="spmd"):
            cache = P.PlanCache(cache_dir)
            srv = P.GNNServer(adj, x, num_shards=SERVING_SHARDS, mode=mode,
                              quant=quant, cache=cache, devices=devices,
                              max_buckets=SPMD_MAX_BUCKETS)
            check(cache.stats.disk_hits == SERVING_SHARDS
                  and cache.stats.misses == 0,
                  f"same plans {plans} {mode} {devices}")
            return srv

        loop = comparing(lambda: server(["cuda:0"], "loop"))
        one = comparing(lambda: server(["cuda:0"]))
        operands = (("resident", None), ("dense_f64", dense))
        want = {label: comparing(lambda: loop.aggregate(op))
                for label, op in operands}
        want_one = {label: comparing(lambda: one.aggregate(op))
                    for label, op in operands}
        one_times = comparing(lambda: timed(one, ["cuda:0"]))
        for name, devices in layouts.items():
            for d in {torch.device(d) for d in devices}:
                torch.cuda.synchronize(d)
            t0 = time.perf_counter()
            srv = server(devices)
            for d in {torch.device(d) for d in devices}:
                torch.cuda.synchronize(d)
            build_s = time.perf_counter() - t0
            slots = srv._bundles
            check(len(slots) == len(devices)
                  and all(b._quant == (quant is not None) for b in slots),
                  f"slots {name} {plans}")
            equal, per_pass = {}, {}
            for label, op in operands:
                got = srv.aggregate(op)
                equal[label] = {
                    "loop": bool(torch.equal(got, want[label])),
                    "one_slot": bool(torch.equal(got, want_one[label]))}
                check(got.device == home and all(equal[label].values())
                      and bool(torch.isfinite(got).all()),
                      f"{name} vs loop and one slot {plans} {label}")
                per_pass[label] = _pass_launches(P, srv, op)
                block = per_pass[label].get("block_ell_spmm", 0)
                deq = per_pass[label].get("dequantize", 0)
                check(block == sum(len(b.buckets) for b in slots)
                      and 1 <= block <= len(slots) * SPMD_MAX_BUCKETS
                      and all(ids for b in slots for _, ids in b.buckets)
                      and deq == (len(slots) if quant and op is None
                                  else 0),
                      f"launches a pass {name} {plans} {label}")
            times = comparing(lambda: timed(srv, devices))
            dispatch = comparing(
                lambda: _dispatch_vs_completion(P, srv, [None]))
            line = {
                "build_s": build_s,
                "groups": [list(g) for g in srv._mesh.groups],
                "buckets": [[[w, len(ids)] for w, ids in b.buckets]
                            for b in slots],
                "operand_rows": [b.gcap * b.num_shards for b in slots],
                "resident_uint8": slots[0]._quant,
                "equal": equal, "launches_a_pass": per_pass,
                "pass_ms": times, "one_slot_pass_ms": one_times,
                "dispatch_vs_completion": dispatch}
            if name == "cards" and plans == "f32":
                base = P.sync_baseline(srv, iters=16, warmup=2)
                pool = [torch.randn((n, SERVING_DENSE_F), generator=gen,
                                    device=home)
                        for _ in range(SERVING_POOL)]
                expected = {None: srv.aggregate()}
                expected.update({id(op): srv.aggregate(op) for op in pool})
                burst = _runtime_line(P, srv, base["rps"], pool, expected)
                line["runtime"] = {
                    "sync_baseline": base, "rate_x_baseline": 1.0,
                    "achieved_x_baseline": burst["achieved_rps"]
                    / base["rps"], **burst}
                check(burst["results_unequal_to_sync"] == 0
                      and burst["completed"] >= 1 and burst["failed"] == 0,
                      "runtime across cards")
                del pool, expected
            lines[name][plans] = line
            del srv, slots
        del loop, one

    for name, line in lines.items():
        log({"phase": "serving_spmd_cards" if name == "cards"
             else "serving_spmd_slots",
             "devices": layouts[name], "cards": cards, **line})
    if cards == 1:
        log({"phase": "serving_spmd_cards", "cards": 1,
             "across_cards": "not run"})
    launches = {k: v - compared.get(k, 0)         # ... and ends here
                for k, v in P.ops.launch_counts().items()}
    log({"phase": "serving_spmd_slots_launches", "launches": launches,
         "comparison_and_timing_launches": compared,
         "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
         "wall_s": time.perf_counter() - t_phase})
    if failures:
        raise AssertionError(f"serving_spmd_slots: {failures} failed (the "
                             "serving_spmd_slots/cards lines above say "
                             "which check)")
    for name in ("block_ell_spmm", "dequantize"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 "spmd slots path")
    return launches


def _spmd_dequantize(P, bundle) -> dict:
    """The ``dequantize`` launch of an int8 resident pass, the call that
    ``bundle.run`` makes (its uint8 stack, its ``[num_shards]`` tables), into
    one output made once: its own device time (:func:`kernel_own_ms`) beside
    its bytes bound (the stack read once as uint8, written once as f32)."""
    torch = P.torch
    q, feat = bundle._resident, bundle._resident.shape[1]
    dst = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    ms, how, _ = kernel_own_ms(torch, lambda: P.ops.dequantize(
        q, bundle._scale, bundle._x_min, bits=bundle._bits, out=dst),
        DEQUANT_KERNEL)
    t_bound, by = bound(q.numel() * (q.element_size() + 4), 2.0 * q.numel())
    return {"stack": [q.shape[0], feat], "segments": bundle.num_shards,
            "ms": ms, "ms_from": how,
            "bound_ms": t_bound, "bound_by": by,
            "share_of_bound": t_bound / ms}


def _pass_launches(P, server, op=None) -> dict:
    """Kernel launches of one pass of ``server`` over ``op`` (None: the
    resident operand)."""
    P.torch.cuda.synchronize()
    before = P.ops.launch_counts()
    server.run_batch([op])
    P.torch.cuda.synchronize()
    return {k: v - before[k] for k, v in P.ops.launch_counts().items()
            if v - before[k]}


#: the command lines of the port, each run as ``python -m`` runs it: the
#: module, its arguments after ``--smoke --json``, and the kernels it must
#: launch (the graph tune times whichever candidates rank first, so its
#: kernels are logged, not required)
CLI_SMOKES = (
    ("repro_torch.exec", (), ("aes_sample", "ell_spmm", "fused_layer")),
    ("repro_torch.tuning.autotune", (), ()),
    ("repro_torch.tuning.autotune", ("--granularity", "block"),
     ("block_ell_spmm",)),
    ("repro_torch.tuning.autotune", ("--shards", "4"), ("block_ell_spmm",)),
    ("repro_torch.tuning.calibration", (), ()),
)
#: runs ``sys.argv[1]`` as ``python -m`` does (``runpy``), with the rest as
#: its arguments, then prints the kernel launches it made to stderr
_CLI_RUNNER = r"""
import json, runpy, sys
from repro_torch.kernels import ops
sys.argv = sys.argv[1:]
try:
    runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
finally:
    print("LAUNCHES " + json.dumps(ops.launch_counts()), file=sys.stderr)
"""


def cli_smokes(P) -> dict:
    """Each command line's ``--smoke --json`` in a process of its own on the
    card (``--device`` left at its default, ``cuda``): it must exit 0, end
    with ``smoke: OK`` and launch the kernels it drives.  Returns the
    launches of all of them."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("REPRO_PLAN_CACHE_DIR", None)
    total = {k: 0 for k in P.ops.KERNELS}
    failures = []
    for module, extra, drives in CLI_SMOKES:
        argv = ["--smoke", "--json", *extra]
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", _CLI_RUNNER, module,
                              *argv], cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        seconds = time.perf_counter() - t0
        lines = out.stdout.splitlines()
        reports = [json.loads(s) for s in lines if s.startswith("{")]
        counted = [s for s in out.stderr.splitlines()
                   if s.startswith("LAUNCHES ")]
        launches = json.loads(counted[-1][9:]) if counted else {}
        ok = (out.returncode == 0 and bool(lines)
              and lines[-1] == "smoke: OK"
              and all(launches.get(k, 0) > 0 for k in drives))
        log({"phase": "cli_smoke",
             "command": " ".join(["python -m", module, *argv]),
             "rc": out.returncode, "ok": ok, "seconds": seconds,
             "report": reports[0] if reports else None,
             "launches": {k: v for k, v in launches.items() if v}})
        if not ok:
            failures.append(module + " " + " ".join(argv))
            print(out.stderr[-4000:], file=sys.stderr)
        for k, v in launches.items():
            total[k] += v
    if failures:
        raise AssertionError(f"cli_smokes: {failures} failed")
    return total


# ---------------------------------------------------------------------------
# phase 4: LM serving
# ---------------------------------------------------------------------------

#: the full-width model of the LM phase, its requests, prompt and
#: generated tokens
LM_ARCH = "qwen2-7b"
LM_REQUESTS, LM_PROMPT, LM_GEN = 8, 1024, 64
#: (name, config options) of the served paths; "full" first
LM_PATHS = (("full", {}), ("aes_kv_256", {"aes_kv_width": 256}),
            ("aes_kv_64", {"aes_kv_width": 64}),
            ("kv_int8", {"kv_quant_bits": 8}),
            ("kv_int8_aes_kv_64", {"kv_quant_bits": 8, "aes_kv_width": 64}))
#: decode steps issued one at a time from an idle card (host/device split)
LM_TIMED_STEPS = 5
#: the decode step at cache_len = P against ``forward`` over P + 1 tokens
#: at its last position: max |difference| over max |logit| of ``forward``,
#: eight bfloat16 unit roundoffs (2**-8): both round every layer's output
#: to bfloat16, from products of different shapes
LM_DECODE_REL_TOL = 2.0 ** -5
#: the int8 cache's next-token softmax against the bfloat16 cache's
#: (tests/test_archs.py:test_kv_int8_decode_close_to_fp)
LM_INT8_PROB_TOL = 0.05
#: smoke configs in float32, card against CPU: forward's logits (float32
#: throughout, TF32 off) and each decode step's, from the CPU's cache
#: (bfloat16 softmax weights and attention output, as in the reference;
#: its own decode tolerance, tests/test_model_blocks.py)
LM_SMOKE_FWD_TOL = 1e-4
LM_SMOKE_DEC_TOL = 2e-3


def _lm_step_split(P, cfg, model, tokens) -> dict:
    """Prefill ``tokens``, then ``LM_TIMED_STEPS`` decode steps, each
    issued from an idle card: the host's time to issue a step (its
    dispatch alone) and the step's time to completion, medians in ms;
    whether every logit was finite."""
    torch = P.torch
    P_len = tokens.shape[1]
    logits, cache = P.prefill(cfg, model, tokens, P_len + LM_GEN)
    tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    del logits
    host, total, finite = [], [], True
    for i in range(LM_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = P.decode_step(model, cfg, cache, tokens=tok,
                                      cache_len=P_len + i)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        total.append((time.perf_counter() - t0) * 1e3)
        host.append((t1 - t0) * 1e3)
        finite &= bool(torch.isfinite(logits).all())
        tok = logits.argmax(dim=-1).to(torch.int32)
    return {"host_ms_per_step": statistics.median(host),
            "step_ms_alone": statistics.median(total),
            "logits_finite": finite}


def _lm_device_profile(P, cfg, model, tokens, steps=3, top=0) -> dict:
    """Device time of one decode step, the sum of its kernels' durations
    in a ``torch.profiler`` trace of ``steps`` steps (None when the trace
    holds no device time), the kernels a step, and the ``top`` kernels by
    device time: [name, ms a step, calls a step]."""
    torch = P.torch
    from torch.profiler import ProfilerActivity, profile

    P_len = tokens.shape[1]
    logits, cache = P.prefill(cfg, model, tokens, P_len + LM_GEN)
    tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    del logits
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            logits, cache = P.decode_step(model, cfg, cache, tokens=tok,
                                          cache_len=P_len + i)
            tok = logits.argmax(dim=-1).to(torch.int32)
        torch.cuda.synchronize()

    events = prof.key_averages()
    us = sum(_device_us(e) for e in events)
    out = {"device_busy_ms_per_step": us / 1e3 / steps if us else None,
           "kernels_per_step": sum(e.count for e in events) / steps}
    if top:
        out["top_kernels"] = [
            [_kernel_label(e.key), _device_us(e) / 1e3 / steps,
             e.count / steps]
            for e in sorted(events, key=_device_us, reverse=True)[:top]]
    return out


def _kernel_label(name: str) -> str:
    """A kernel's name cut to what tells kernels apart: the GEMM's own
    name, or an elementwise kernel's launcher and its functors and
    dtypes (the template arguments run to hundreds of characters)."""
    if not name.startswith("void at::native"):
        return name[:64]
    parts = re.findall(r"\w*(?:Functor|_kernel)\w*|BFloat16|float|long", name)
    return " ".join(dict.fromkeys(parts))[:160]


def _to_device(tree, device):
    """A copy of a (nested) cache on ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device, copy=True)


def _lm_gates(P, cfg, model, tokens, int8=True, chunk=1) -> dict:
    """At ``cache_len = P`` after the prefill of ``tokens``: the decode
    step against ``forward`` over P + 1 tokens (padded with copies of the
    new token to P + ``chunk``, where the chunked scans of the pattern
    blocks need whole chunks: later positions cannot reach position P),
    AES-KV at W = S_max against full attention (bit for bit), and with
    ``int8`` the int8 cache's softmax against the bfloat16 cache's."""
    torch = P.torch
    P_len = tokens.shape[1]
    S_max = P_len + LM_GEN
    logits, cache = P.prefill(cfg, model, tokens, S_max)
    tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    del logits
    wide_cache = _to_device(cache, tokens.device)
    dec, _ = P.decode_step(model, cfg, cache, tokens=tok, cache_len=P_len)
    wide, _ = P.decode_step(model, cfg.with_aes_kv(S_max), wide_cache,
                            tokens=tok, cache_len=P_len)
    wide_equal = bool(torch.equal(dec, wide))
    del cache, wide_cache, wide
    seq = torch.cat([tokens, tok.expand(-1, chunk)], 1)
    full, _, _ = P.forward(model, cfg, tokens=seq)
    last = full[:, P_len:P_len + 1].clone()
    del full
    err = float((dec - last).abs().max())
    scale = float(last.abs().max())
    out = {"decode_vs_forward_max_abs_err": err,
           "forward_max_abs_logit": scale,
           "decode_vs_forward_rel_err": err / scale,
           "decode_vs_forward_rel_tol": LM_DECODE_REL_TOL,
           "decode_vs_forward_argmax_agree": float(
               (dec.argmax(-1) == last.argmax(-1)).float().mean()),
           "aes_kv_s_max_logits_bit_equal": wide_equal}
    finite = [dec, last]
    if int8:
        qcfg = cfg.with_options(kv_quant_bits=8)
        logits, qcache = P.prefill(qcfg, model, tokens, S_max)
        del logits
        qdec, _ = P.decode_step(model, qcfg, qcache, tokens=tok,
                                cache_len=P_len)
        del qcache
        out["int8_softmax_max_abs_err"] = float(
            (torch.softmax(qdec, -1) - torch.softmax(dec, -1)).abs().max())
        out["int8_softmax_tol"] = LM_INT8_PROB_TOL
        finite.append(qdec)
    out["logits_finite"] = all(bool(torch.isfinite(t).all())
                               for t in finite)
    return out


def lm_serve_path(P) -> dict:
    """LM serving at full width: ``LM_ARCH`` unreduced in bfloat16, its
    weights drawn on the card from seed 0, served on each of
    ``LM_PATHS`` (and AES-KV at W = S_max, which must equal full
    attention bit for bit) with ``launch.serve.serve``; then the gates of
    :func:`_lm_gates`.  Returns the kernel launches of the run (counts set
    to 0 at its start: the LM path launches none)."""
    torch, np = P.torch, P.np
    device = torch.device("cuda")
    cfg = P.get_config(LM_ARCH)
    P.ops.reset_launch_counts()               # the LM path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = P.init_params(cfg, 0, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    params = list(model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in params)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log({"phase": "lm_model", "arch": LM_ARCH, "param_dtype":
         cfg.param_dtype, "layers": cfg.num_layers, "d_model": cfg.d_model,
         "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
         "head_dim": cfg.resolved_head_dim, "d_ff": cfg.d_ff,
         "vocab": cfg.vocab_size, "params": sum(p.numel() for p in params),
         "param_bytes": nbytes, "weight_read_bound_ms": bound_ms,
         "init_s": init_s})
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT)).astype(np.int32)
    tokens = torch.as_tensor(prompts, device=device)
    S_max = LM_PROMPT + LM_GEN
    failures, full = [], None
    for name, opts in LM_PATHS + (("aes_kv_s_max",
                                   {"aes_kv_width": S_max}),):
        c = cfg.with_options(**opts)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gen, stats = P.serve(c, model, prompts, LM_GEN, device=device)
        peak = torch.cuda.max_memory_allocated()
        split = _lm_step_split(P, c, model, tokens)
        full = gen if full is None else full
        line = {"phase": "lm_serve", "arch": LM_ARCH, "path": name, **opts,
                "requests": LM_REQUESTS, "prompt": LM_PROMPT,
                "gen": LM_GEN, "prefill_s": stats.prefill_s,
                "decode_s": stats.decode_s, "tok_per_s": stats.tok_per_s,
                "ms_per_step": stats.decode_s / (LM_GEN - 1) * 1e3,
                "weight_read_bound_ms": bound_ms, **split,
                "peak_memory_gb": peak / 1e9,
                "greedy_agreement_vs_full": float((gen == full).mean())}
        if name == "full":
            line.update(_lm_device_profile(P, c, model, tokens))
        log(line)
        if not split["logits_finite"]:
            failures.append(f"{name}: a logit is not finite")
        if name == "aes_kv_s_max" and not np.array_equal(gen, full):
            failures.append("AES-KV at W = S_max: tokens differ from full "
                            "attention")
    gates = _lm_gates(P, cfg, model, tokens)
    log({"phase": "lm_serve_gates", "arch": LM_ARCH, **gates})
    if not gates["aes_kv_s_max_logits_bit_equal"]:
        failures.append("AES-KV at W = S_max: logits differ from full "
                        "attention")
    if not gates["decode_vs_forward_rel_err"] <= LM_DECODE_REL_TOL:
        failures.append("decode step vs forward over P + 1 tokens: "
                        f"{gates['decode_vs_forward_rel_err']} > "
                        f"{LM_DECODE_REL_TOL} of the largest logit")
    if not gates["int8_softmax_max_abs_err"] < LM_INT8_PROB_TOL:
        failures.append("int8 cache softmax vs bfloat16: "
                        f"{gates['int8_softmax_max_abs_err']}")
    if not gates["logits_finite"]:
        failures.append("a gate's logits are not finite")
    del model
    torch.cuda.empty_cache()
    failures += lm_smoke_card_vs_cpu(P)
    launched = P.ops.launch_counts()
    if any(launched.values()):
        failures.append(f"the LM path launched {launched}")
    if failures:
        raise AssertionError("lm_serve: " + "; ".join(failures))
    return launched


def lm_smoke_card_vs_cpu(P) -> list:
    """Each of the ten archs' smoke config in float32, one set of weights
    on the card and on the CPU: token archs served on both (greedy tokens
    equal; full attention, and AES-KV at W = 8 over the int8 cache where
    the cache is a uniform K/V cache), every arch's forward logits and
    four decode steps' (each from the CPU's cache; frontend stubs through
    ``embeds=``) within ``LM_SMOKE_FWD_TOL`` / ``LM_SMOKE_DEC_TOL``.
    Returns the failures."""
    import copy

    torch, np = P.torch, P.np
    device = torch.device("cuda")
    failures = []
    for arch in P.ALL_ARCHS:
        cfg = P.smoke_config(P.get_config(arch)).with_options(
            param_dtype="float32")
        cpu_model = P.init_params(cfg, 0, device="cpu")
        card_model = copy.deepcopy(cpu_model).to(device)
        rng = np.random.default_rng(0)
        B, S, steps = 4, 16, 4
        line = {"phase": "lm_smoke_card_vs_cpu", "arch": arch}
        if cfg.frontend is None:
            prompts = rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
            variants = [{}] + ([{"aes_kv_width": 8, "kv_quant_bits": 8}]
                               if cfg.mla is None and cfg.block_pattern is None
                               else [])
            equal, served = [], []
            for opts in variants:
                c = cfg.with_options(**opts)
                want, _ = P.serve(c, cpu_model, prompts, 8, device="cpu")
                got, _ = P.serve(c, card_model, prompts, 8, device=device)
                equal.append(bool(np.array_equal(got, want)))
                served.append(want)
            line["serve_tokens_equal"] = equal
            if not all(equal):
                failures.append(f"{arch}: served tokens differ card vs CPU")
            first = {"tokens": torch.from_numpy(prompts)}
            nexts = [{"tokens": torch.from_numpy(served[0][:, i:i + 1].copy())}
                     for i in range(steps)]
        else:
            first = {"embeds": torch.from_numpy(
                rng.normal(size=(B, S, cfg.d_model)).astype(np.float32))}
            nexts = [{"embeds": torch.from_numpy(
                rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32))}
                for _ in range(steps)]

        want, _, cache = P.forward(cpu_model, cfg, want_cache=True, **first)
        got, _, _ = P.forward(card_model, cfg, want_cache=True,
                              **_to_device(first, device))
        fwd_err = float((got.cpu() - want).abs().max())
        cache = P.grow_cache(cache, S + steps)
        dec_err = 0.0
        for i, step in enumerate(nexts):
            got, _ = P.decode_step(card_model, cfg, _to_device(cache, device),
                                   cache_len=S + i,
                                   **_to_device(step, device))
            want, cache = P.decode_step(cpu_model, cfg, cache,
                                        cache_len=S + i, **step)
            dec_err = max(dec_err, float((got.cpu() - want).abs().max()))
        line.update(forward_max_abs_err=fwd_err, forward_tol=LM_SMOKE_FWD_TOL,
                    decode_max_abs_err=dec_err, decode_tol=LM_SMOKE_DEC_TOL)
        log(line)
        if not (fwd_err <= LM_SMOKE_FWD_TOL and dec_err <= LM_SMOKE_DEC_TOL):
            failures.append(f"{arch}: logits card vs CPU {fwd_err} / "
                            f"{dec_err}")
    return failures


#: the pattern archs served at full width ("full", AES-KV at W = 256 and at
#: W = S_max on Zamba2's shared attention; xLSTM has no attention cache)
LM_PATTERN_ARCHS = ("zamba2-7b", "xlstm-350m")
#: the chunk of ``mamba_block``/``mlstm_block``'s scan: a prefill or
#: forward covers whole chunks of it
LM_SCAN_CHUNK = 128
#: kernels of a Zamba2 decode step listed by device time
LM_TOP_KERNELS = 12


def _decode_bytes(P, cfg, model, batch: int, kv_positions: int) -> dict:
    """Bytes a decode step must move: every weight once, but only the
    embedding rows of the batch and the weight-shared attention + MLP
    once an application; every recurrent state and conv cache read and
    written; each attention cache's K/V read at ``kv_positions``
    positions; the float32 logits written."""
    def nbytes(tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    weights = (nbytes(model.parameters()) - nbytes([model.embed])
               + batch * model.embed.shape[1] * model.embed.element_size())
    if hasattr(model, "shared_attn"):
        apps = (len(model.groups) if hasattr(model, "groups")
                else cfg.block_pattern.count("shared_attn"))
        weights += (apps - 1) * nbytes(list(model.shared_attn.parameters())
                                       + list(model.shared_mlp.parameters()))
    states = kv = 0

    def walk(tree, name=""):
        nonlocal states, kv
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, k)
        elif isinstance(tree, list):
            for v in tree:
                walk(v, name)
        elif name in ("k", "v"):
            kv += tree.numel() * tree.element_size()
        else:
            states += 2 * tree.numel() * tree.element_size()

    walk(P.init_cache(cfg, batch, kv_positions, device="meta"))
    logits = batch * cfg.vocab_size * 4
    total = weights + states + kv + logits
    return {"weight_bytes": weights, "state_bytes": states, "kv_bytes": kv,
            "logit_bytes": logits, "bytes_per_step": total,
            "bytes_bound_ms": total / HBM_BYTES_PER_S * 1e3}


def lm_pattern_serve_path(P) -> dict:
    """The pattern families at full width: ``LM_PATTERN_ARCHS`` unreduced
    in bfloat16, weights drawn on the card from seed 0, served by
    ``launch.serve.serve`` to ``LM_REQUESTS`` x ``LM_PROMPT`` prompt
    tokens x ``LM_GEN`` generated tokens (Zamba2 also with AES-KV at
    W = 256 and at W = S_max, which must equal full attention); each line
    with the bytes-a-step bound of :func:`_decode_bytes` (the full path
    also with the device's busy ms and its costliest kernels from a
    ``torch.profiler`` trace); then :func:`_lm_gates` without the int8
    cache (the pattern caches have none), the forward padded to whole
    scan chunks, in bfloat16 and on a float32 copy of the weights
    (decode vs forward gated in float32 only).  Returns the kernel launches of the run (counts set to 0
    at its start: it launches none)."""
    torch, np = P.torch, P.np
    device = torch.device("cuda")
    S_max = LM_PROMPT + LM_GEN
    P.ops.reset_launch_counts()          # the pattern path starts here
    failures = []
    for arch in LM_PATTERN_ARCHS:
        cfg = P.get_config(arch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = P.init_params(cfg, 0, device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        params = list(model.parameters())
        log({"phase": "lm_model", "arch": arch, "param_dtype":
             cfg.param_dtype, "layers": cfg.num_layers,
             "d_model": cfg.d_model, "heads": cfg.num_heads,
             "ssm_state": cfg.ssm_state, "attn_every": cfg.attn_every,
             "blocks": {k: cfg.block_pattern.count(k)
                        for k in sorted(set(cfg.block_pattern))},
             "vocab": cfg.vocab_size,
             "params": sum(p.numel() for p in params),
             "param_bytes": sum(p.numel() * p.element_size()
                                for p in params), "init_s": init_s})
        prompts = np.random.default_rng(0).integers(
            1, cfg.vocab_size, (LM_REQUESTS, LM_PROMPT)).astype(np.int32)
        tokens = torch.as_tensor(prompts, device=device)
        paths = [("full", {})]
        if "shared_attn" in cfg.block_pattern:
            paths += [("aes_kv_256", {"aes_kv_width": 256}),
                      ("aes_kv_s_max", {"aes_kv_width": S_max})]
        full = None
        for name, opts in paths:
            c = cfg.with_options(**opts)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            gen, stats = P.serve(c, model, prompts, LM_GEN, device=device)
            peak = torch.cuda.max_memory_allocated()
            split = _lm_step_split(P, c, model, tokens)
            full = gen if full is None else full
            positions = min(c.aes_kv_width or S_max, LM_PROMPT + LM_GEN // 2)
            line = {"phase": "lm_pattern_serve", "arch": arch, "path": name,
                    **opts, "requests": LM_REQUESTS, "prompt": LM_PROMPT,
                    "gen": LM_GEN, "prefill_s": stats.prefill_s,
                    "decode_s": stats.decode_s, "tok_per_s": stats.tok_per_s,
                    "ms_per_step": stats.decode_s / (LM_GEN - 1) * 1e3,
                    **_decode_bytes(P, c, model, LM_REQUESTS, positions),
                    "kv_positions_in_bound": positions, **split,
                    "peak_memory_gb": peak / 1e9,
                    "greedy_agreement_vs_full": float((gen == full).mean())}
            if name == "full":
                line.update(_lm_device_profile(P, c, model, tokens,
                                               top=LM_TOP_KERNELS))
            log(line)
            if not split["logits_finite"]:
                failures.append(f"{arch} {name}: a logit is not finite")
            if name == "aes_kv_s_max" and not np.array_equal(gen, full):
                failures.append(f"{arch}: AES-KV at W = S_max: tokens "
                                "differ from full attention")
        # decode vs forward is gated on a float32 copy of the weights: in
        # bfloat16 the residual stream's rounding compounds over the depth
        # (xLSTM 4-9% of the largest logit; the reference's own decode
        # 4.4% on the CPU), so there it is logged, not gated
        for dtype in ("bfloat16", "float32"):
            if dtype == "float32":
                model = model.float()
            c = cfg.with_options(param_dtype=dtype)
            gates = _lm_gates(P, c, model, tokens, int8=False,
                              chunk=LM_SCAN_CHUNK)
            gated = dtype == "float32"
            log({"phase": "lm_pattern_serve_gates", "arch": arch,
                 "param_dtype": dtype, "decode_vs_forward_gated": gated,
                 **gates})
            if not gates["aes_kv_s_max_logits_bit_equal"]:
                failures.append(f"{arch} {dtype}: AES-KV at W = S_max: "
                                "logits differ")
            if gated and not (gates["decode_vs_forward_rel_err"]
                              <= LM_DECODE_REL_TOL):
                failures.append(f"{arch} {dtype}: decode step vs forward: "
                                f"{gates['decode_vs_forward_rel_err']} > "
                                f"{LM_DECODE_REL_TOL} of the largest logit")
            if not gates["logits_finite"]:
                failures.append(f"{arch} {dtype}: a gate's logits are not "
                                "finite")
        del model, params
        torch.cuda.empty_cache()
    launched = P.ops.launch_counts()
    if any(launched.values()):
        failures.append(f"the pattern path launched {launched}")
    if failures:
        raise AssertionError("lm_pattern_serve: " + "; ".join(failures))
    return launched


#: the full-width training run: the reference launcher's defaults
#: (batch 8, sequence 256, lr 3e-4, the cosine schedule), remat on
LM_TRAIN_ARCH = "tinyllama-1.1b"
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_LR = 8, 256, 3e-4
LM_TRAIN_STEPS = 10
#: ``main --grad-compress``: its schedule's lr is 0 at step 0 (warmup),
#: so the third step's loss is the first a compressed update moves
LM_TRAIN_COMPRESS_STEPS = 3
#: xLSTM at full width on one constant batch, at the launcher's lr (the
#: smoke tests' 3e-3 diverges at this width: 11.3 -> 16.3 in 5 steps)
LM_TRAIN_XLSTM_STEPS, LM_TRAIN_XLSTM_LR = 5, 3e-4
#: the resume gate (smoke config): losses of the resumed steps against an
#: uninterrupted run's, relative (the embedding's gradient sums in atomic
#: order on the card, and AdamW's first steps move a weight by about lr
#: times its gradient's sign, so one last-bit difference moves the loss)
LM_RESUME_STEPS, LM_RESUME_FAIL_AT, LM_RESUME_EVERY = 8, 5, 4
LM_RESUME_TOL = 1e-3


def _train_run(P, cfg, step_fn, state, batch_at, steps: int) -> tuple:
    """``steps`` steps from ``state``; (state, losses, seconds a step)."""
    torch = P.torch
    losses, times = [], []
    for i in range(steps):
        batch = batch_at(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        times.append(time.perf_counter() - t0)
    return state, losses, times


def _resume_gate(P, device) -> dict:
    """The checkpoint, injected-failure and resume path at smoke size on
    the card: an uninterrupted run of ``LM_RESUME_STEPS``; a run that
    checkpoints every ``LM_RESUME_EVERY`` steps and fails at
    ``LM_RESUME_FAIL_AT``; its last checkpoint restored bit for bit (the
    bfloat16 parameters as their bits); a runner resuming from it whose
    losses match the uninterrupted run's."""
    import tempfile

    torch, np = P.torch, P.np
    cfg = P.smoke_config(P.get_config(LM_TRAIN_ARCH))
    model = P.init_params(cfg, 0, device=device)
    params = {k: p.detach() for k, p in model.named_parameters()}
    state0 = (params, P.adamw_init(params))
    step_fn = P.make_train_step(cfg, model, P.cosine_with_warmup(
        LM_TRAIN_LR, 1, LM_RESUME_STEPS))
    pipe = P.make_pipeline(cfg, seq_len=64, global_batch=4)

    def batch_at(step):
        return {k: torch.as_tensor(v, device=device)
                for k, v in pipe.batch_at(step).items()}

    def recording(losses, states):
        def run(state, batch):
            state, metrics = step_fn(state, batch)
            losses.append(float(metrics["loss"]))
            states.append(state)
            return state, metrics
        return run

    out = {"phase": "lm_train_resume", "arch": LM_TRAIN_ARCH,
           "config": "smoke", "steps": LM_RESUME_STEPS,
           "fail_at": LM_RESUME_FAIL_AT, "ckpt_every": LM_RESUME_EVERY}
    with tempfile.TemporaryDirectory() as tmp:
        clean, clean_states = [], []
        P.FaultTolerantRunner(P.RunnerConfig(
            LM_RESUME_STEPS, f"{tmp}/clean", ckpt_every=100)).run(
            recording(clean, clean_states), state0, batch_at, start_step=0)
        failed, failed_states = [], []
        try:
            P.FaultTolerantRunner(P.RunnerConfig(
                LM_RESUME_STEPS, f"{tmp}/ft", ckpt_every=LM_RESUME_EVERY,
                inject_failure_at=LM_RESUME_FAIL_AT)).run(
                recording(failed, failed_states), state0, batch_at,
                start_step=0)
            out["failure_raised"] = False
        except P.SimulatedFailure:
            out["failure_raised"] = True
        saved = P.latest_step(f"{tmp}/ft")
        restored = P.restore_checkpoint(f"{tmp}/ft", saved, state0)
        bits = [(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                 b.cpu().view(torch.int16) if b.dtype == torch.bfloat16
                 else b.cpu())
                for (_, a), (_, b) in zip(P.flatten(restored),
                                          P.flatten(failed_states[saved - 1]))]
        out["checkpoint_step"] = saved
        out["checkpoint_bit_exact"] = all(torch.equal(a, b) for a, b in bits)
        resumed = []
        _, step, _ = P.FaultTolerantRunner(P.RunnerConfig(
            LM_RESUME_STEPS, f"{tmp}/ft", ckpt_every=LM_RESUME_EVERY)).run(
            recording(resumed, []), state0, batch_at)
    want = clean[saved:]
    out.update(resumed_from=saved, steps_done=step, clean_losses=clean,
               resumed_losses=resumed,
               resumed_bit_equal=resumed == want,
               resumed_max_rel_err=float(np.max(np.abs(
                   np.array(resumed) - np.array(want)) / np.abs(want)))
               if len(resumed) == len(want) else None,
               tol=LM_RESUME_TOL)
    return out


def lm_train_path(P) -> dict:
    """LM training on the card: ``LM_TRAIN_ARCH`` unreduced in bfloat16
    through ``launch.train.make_train_step`` (AdamW, weight decay 0.1,
    remat on) with the token pipeline and the cosine schedule, s a step
    and tokens/s beside the 6 N tokens bound at the bfloat16 rate, peak
    memory, first and last loss; ``LM_TRAIN_COMPRESS_STEPS`` steps of
    ``launch.train.main --grad-compress``; xLSTM-350M unreduced on one
    constant batch, whose loss must fall; then :func:`_resume_gate`.
    Zamba2 is not trained here: its float32 moments alone (45.7 GB) and
    its parameters and gradients (22.9 GB) leave no room for
    activations.  Returns the kernel launches (counts set to 0 at its
    start: it launches none)."""
    import tempfile

    torch, np = P.torch, P.np
    device = torch.device("cuda")
    P.ops.reset_launch_counts()          # the training path starts here
    failures = []

    cfg = P.get_config(LM_TRAIN_ARCH)
    model = P.init_params(cfg, 0, device=device)
    params = {k: p.detach() for k, p in model.named_parameters()}
    n_params = sum(p.numel() for p in params.values())
    pipe = P.make_pipeline(cfg, seq_len=LM_TRAIN_SEQ,
                           global_batch=LM_TRAIN_BATCH)
    step_fn = P.make_train_step(cfg, model, P.cosine_with_warmup(
        LM_TRAIN_LR, warmup_steps=max(LM_TRAIN_STEPS // 20, 1),
        total_steps=LM_TRAIN_STEPS))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, losses, times = _train_run(
        P, cfg, step_fn, (params, P.adamw_init(params)),
        lambda i: {k: torch.as_tensor(v, device=device)
                   for k, v in pipe.batch_at(i).items()}, LM_TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    flops = 6 * n_params * tokens
    s_step = statistics.median(times[1:])
    log({"phase": "lm_train", "arch": LM_TRAIN_ARCH, "param_dtype":
         cfg.param_dtype, "params": n_params, "batch": LM_TRAIN_BATCH,
         "seq": LM_TRAIN_SEQ, "remat_policy": cfg.remat_policy or "full",
         "steps": LM_TRAIN_STEPS, "first_step_s": times[0],
         "s_per_step": s_step, "tokens_per_s": tokens / s_step,
         "flop_per_step": flops,
         "flop_bound_ms": flops / BF16_FLOP_PER_S * 1e3,
         "bound_share": flops / BF16_FLOP_PER_S / s_step,
         "peak_memory_gb": peak / 1e9, "first_loss": losses[0],
         "last_loss": losses[-1], "losses": losses})
    if not np.isfinite(losses).all():
        failures.append(f"{LM_TRAIN_ARCH}: a loss is not finite")
    del state, params, model, step_fn
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        compressed = P.train_main([
            "--arch", LM_TRAIN_ARCH, "--steps", str(LM_TRAIN_COMPRESS_STEPS),
            "--seq", str(LM_TRAIN_SEQ), "--batch", str(LM_TRAIN_BATCH),
            "--grad-compress", "--ckpt-dir", tmp, "--ckpt-every", "100",
            "--device", "cuda"])
    log({"phase": "lm_train_grad_compress", "arch": LM_TRAIN_ARCH,
         "steps": LM_TRAIN_COMPRESS_STEPS, "losses": compressed,
         "wall_s": time.perf_counter() - t0})
    if not np.isfinite(compressed).all():
        failures.append("--grad-compress: a loss is not finite")
    torch.cuda.empty_cache()

    cfg = P.get_config("xlstm-350m")
    model = P.init_params(cfg, 0, device=device)
    params = {k: p.detach() for k, p in model.named_parameters()}
    batch = {k: torch.as_tensor(v, device=device) for k, v in P.make_pipeline(
        cfg, seq_len=LM_TRAIN_SEQ, global_batch=LM_TRAIN_BATCH
    ).batch_at(0).items()}
    torch.cuda.reset_peak_memory_stats()
    _, losses, times = _train_run(
        P, cfg, P.make_train_step(cfg, model, P.constant(LM_TRAIN_XLSTM_LR)),
        (params, P.adamw_init(params)), lambda i: batch,
        LM_TRAIN_XLSTM_STEPS)
    log({"phase": "lm_train", "arch": "xlstm-350m", "params":
         sum(p.numel() for p in params.values()), "batch": LM_TRAIN_BATCH,
         "seq": LM_TRAIN_SEQ, "constant_batch": True,
         "lr": LM_TRAIN_XLSTM_LR, "steps": LM_TRAIN_XLSTM_STEPS,
         "first_step_s": times[0], "s_per_step": statistics.median(times[1:]),
         "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
         "first_loss": losses[0], "last_loss": losses[-1],
         "losses": losses})
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        failures.append(f"xlstm-350m: the loss did not fall: {losses}")
    del params, model
    torch.cuda.empty_cache()

    gate = _resume_gate(P, device)
    log(gate)
    if not (gate["failure_raised"] and gate["checkpoint_bit_exact"]
            and gate["steps_done"] == LM_RESUME_STEPS
            and gate["resumed_max_rel_err"] is not None
            and gate["resumed_max_rel_err"] <= LM_RESUME_TOL):
        failures.append(f"resume gate: {gate}")
    launched = P.ops.launch_counts()
    if any(launched.values()):
        failures.append(f"the training path launched {launched}")
    if failures:
        raise AssertionError("lm_train: " + "; ".join(failures))
    return launched


# ---------------------------------------------------------------------------
# phase 4: the device mesh (each part in a process of its own)
# ---------------------------------------------------------------------------

#: ``lm_mesh``: the training phase's model and batch, steps on a 1x1 mesh
LM_MESH_STEPS = 3
#: ``lm_dryrun``: the reference's own gate cell and the cell a card run
#: of an earlier attempt failed on, each run with --device cuda and cpu
LM_DRYRUN_CELLS = (("tinyllama-1.1b", "decode_32k"), ("qwen2-7b", "train_4k"))
#: what may differ between a cell's two runs: timings and the device
LM_DRYRUN_FREE = ("build_s", "step_s", "device")


def lm_mesh_child() -> None:
    """``python3 chip_smoke.py --lm-mesh`` (run by :func:`lm_mesh_path`):
    ``LM_TRAIN_ARCH`` unreduced, remat on, ``LM_MESH_STEPS`` steps of
    ``make_train_step`` plainly and on DTensors over a 1x1 mesh of a
    one-rank nccl group (``sharded_step``, under ``implicit_replication``),
    from one state and batches, deterministic algorithms on (the
    embedding's gradient otherwise sums in atomic order); then
    ``launch.train.main`` with ``--production-mesh`` and ``--multi-pod``,
    which start their own one-rank group and must raise ``ValueError``
    naming 256 and 512 ranks.  Prints one JSON line."""
    import os

    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    P = port()
    torch = P.torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    device = torch.device("cuda")
    P.ops.reset_launch_counts()
    cfg = P.get_config(LM_TRAIN_ARCH)
    model = P.init_params(cfg, 0, device=device)
    params = {k: p.detach() for k, p in model.named_parameters()}
    pipe = P.make_pipeline(cfg, seq_len=LM_TRAIN_SEQ,
                           global_batch=LM_TRAIN_BATCH)
    batches = [{k: torch.as_tensor(v, device=device)
                for k, v in pipe.batch_at(i).items()}
               for i in range(LM_MESH_STEPS)]
    step_fn = P.make_train_step(cfg, model, P.constant(LM_TRAIN_LR))
    state0 = (params, P.adamw_init(params))
    out = {"phase": "lm_mesh", "arch": LM_TRAIN_ARCH,
           "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ,
           "remat_policy": cfg.remat_policy or "full",
           "steps": LM_MESH_STEPS}
    state, plain, plain_s = _train_run(P, cfg, step_fn, state0,
                                       lambda i: batches[i], LM_MESH_STEPS)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = P.make_local_mesh(device=device)
        specs = P.state_shardings(mesh, state0)
        placed = P.place(state0, specs, mesh)
        placed, meshed, mesh_s = _train_run(
            P, cfg, P.sharded_step(step_fn, mesh, specs), placed,
            lambda i: batches[i], LM_MESH_STEPS)
        equal = all(torch.equal(state[0][k], placed[0][k].full_tensor())
                    for k in state[0])
        out.update(mesh=list(mesh.shape), plain_losses=plain,
                   mesh_losses=meshed, losses_equal=plain == meshed,
                   params_equal=equal,
                   plain_s_per_step=statistics.median(plain_s[1:]),
                   mesh_s_per_step=statistics.median(mesh_s[1:]),
                   plain_first_step_s=plain_s[0],
                   mesh_first_step_s=mesh_s[0])
    finally:
        dist.destroy_process_group()
    del state, placed
    torch.cuda.empty_cache()
    refused = {}
    for flag, need in (("--production-mesh", "256"), ("--multi-pod", "512")):
        try:
            P.train_main(["--arch", LM_TRAIN_ARCH, "--steps", "1", flag,
                          "--device", "cuda"])
            refused[flag] = "no error"
        except ValueError as exc:
            refused[flag] = str(exc) if need in str(exc) else f"wrong: {exc}"
    out.update(refused=refused, group_left=dist.is_initialized(),
               launches={k: v for k, v in P.ops.launch_counts().items()
                         if v})
    print(json.dumps(out), flush=True)


def _child(args: list, timeout: int) -> tuple:
    """A child process of this script or the port, from the checkout's
    root; (return code, stdout, stderr)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=timeout)
    return out.returncode, out.stdout, out.stderr


def lm_mesh_path() -> None:
    """The ``lm_mesh`` line from :func:`lm_mesh_child` in its own process;
    fails unless the mesh's losses and parameters equal the plain step's,
    both flags raise their ``ValueError``, no group is left and no
    kernel launched."""
    rc, stdout, stderr = _child([str(Path(__file__).resolve()), "--lm-mesh"],
                                900)
    lines = [json.loads(s) for s in stdout.splitlines() if s.startswith("{")]
    if rc != 0 or not lines:
        print(stderr[-4000:], file=sys.stderr)
        raise AssertionError(f"lm_mesh: the child failed (rc {rc})")
    line = lines[-1]
    log(line)
    ok = (line["losses_equal"] and line["params_equal"]
          and all(not v.startswith(("no error", "wrong"))
                  for v in line["refused"].values())
          and not line["group_left"] and not line["launches"])
    if not ok:
        raise AssertionError(f"lm_mesh: {line}")


def lm_dryrun_path() -> None:
    """Each ``LM_DRYRUN_CELLS`` cell by ``python -m
    repro_torch.launch.dryrun`` with ``--device cuda`` and again with
    ``--device cpu``, each in its own process (a fake 256-rank group);
    fails unless both are OK and their JSONs equal in every field but
    ``LM_DRYRUN_FREE``."""
    art = ROOT / "artifacts" / "dryrun_torch"
    for arch, shape in LM_DRYRUN_CELLS:
        runs = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            rc, stdout, stderr = _child(
                ["-m", "repro_torch.launch.dryrun", "--arch", arch,
                 "--shape", shape, "--device", device], 900)
            record = json.loads(
                (art / f"{arch}__{shape}__16x16.json").read_text())
            runs[device] = (rc, record, time.perf_counter() - t0)
            if rc != 0:
                print(stderr[-4000:], file=sys.stderr)
        same = {k: v for k, v in runs["cuda"][1].items()
                if k not in LM_DRYRUN_FREE}
        other = {k: v for k, v in runs["cpu"][1].items()
                 if k not in LM_DRYRUN_FREE}
        differ = sorted(k for k in set(same) | set(other)
                        if same.get(k) != other.get(k))
        cuda = runs["cuda"][1]
        log({"phase": "lm_dryrun", "arch": arch, "shape": shape,
             "mesh": cuda["mesh"],
             "status": {d: r[1]["status"] for d, r in runs.items()},
             "wall_s": {d: r[2] for d, r in runs.items()},
             "step_s": {d: r[1].get("step_s") for d, r in runs.items()},
             "differ": differ, "memory": cuda.get("memory"),
             "flops_per_device": cuda.get("flops_per_device"),
             "collective_bytes_per_device":
                 cuda.get("collective_bytes_per_device"),
             "error": {d: r[1].get("error") for d, r in runs.items()
                       if r[1]["status"] != "OK"}})
        if any(r[0] != 0 or r[1]["status"] != "OK" for r in runs.values()) \
                or differ:
            raise AssertionError(f"lm_dryrun {arch} {shape}: status "
                                 f"{[r[1]['status'] for r in runs.values()]}"
                                 f", fields differing {differ}")


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


#: what the dequantization kernel's name holds in a profiler trace
DEQUANT_KERNEL = "dequant_kernel"


def _device_us(e) -> float:
    """A ``key_averages()`` entry's device time, in us."""
    return (getattr(e, "self_device_time_total", None)
            or getattr(e, "self_cuda_time_total", 0))


def kernel_own_ms(torch, fn, kernel, batch=TIMING_BATCH, reps=TIMING_REPS,
                  warmup=3) -> tuple:
    """The device time of one launch of the kernels whose name holds
    ``kernel``, in ms, how it was read, and their launches in the read:
    their device time in a ``torch.profiler`` trace of ``batch`` calls of
    ``fn`` over their count (``"profiler"``); where the trace holds no
    device time for them, ``batch`` calls captured in one CUDA graph and
    its replays timed between CUDA events, the median of ``reps`` over
    ``batch`` (``"graph"``: the time of a whole call of ``fn``, which
    should then launch that kernel alone, once).
    Neither reading holds the host's time, so the kernel's own time stands
    even where the host queues slower than the card runs."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(batch):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    us, count = sum(_device_us(e) for e in hits), sum(e.count for e in hits)
    if us and count:
        return us / 1e3 / count, "profiler", count
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(batch):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times), "graph", batch


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


#: Reddit's layer-1 operand at its published size (232,965 nodes, 602
#: features, as the benchmark's ``gcn-reddit`` cells give it): B of 561 MB
#: in f32 and 140 MB in uint8, both above an H100's L2, so ``ell_spmm``
#: gathers them panel by panel; make_dataset's Reddit (128 features) and
#: the hidden width stay below the panel rule
PANEL_ROWS, PANEL_FEAT = 232_965, 602
#: average edges a row of its graph: the benchmark's Reddit keeps about 121
#: live slots a row at W = 128, where the gather is bound by bytes
PANEL_AVG_DEG = 121


def panel_graph(P, device):
    """A graph of PANEL_ROWS rows drawn on the card from seed 31:
    lognormal degrees (sigma 1) scaled to average PANEL_AVG_DEG, every
    64th row empty, sources uniform over the rows, values normal."""
    torch = P.torch
    gen = torch.Generator(device=device).manual_seed(31)
    deg = torch.empty(PANEL_ROWS, device=device).log_normal_(
        0.0, 1.0, generator=gen)
    deg = (deg / deg.mean() * PANEL_AVG_DEG).long()
    deg[::64] = 0
    row_ptr = torch.zeros(PANEL_ROWS + 1, dtype=torch.int64, device=device)
    row_ptr[1:] = torch.cumsum(deg, 0)
    nnz = int(row_ptr[-1])
    col = torch.randint(0, PANEL_ROWS, (nnz,), generator=gen, device=device,
                        dtype=torch.int32)
    val = torch.randn(nnz, generator=gen, device=device)
    return P.CSR(row_ptr.to(torch.int32), col, val, PANEL_ROWS)


def ell_panel_entry(P, device, timer, plain_timer) -> dict:
    """``ell_spmm`` on Reddit's layer-1 operand (PANEL_ROWS x PANEL_FEAT,
    f32 and uint8) over :func:`panel_graph` sampled at W_MAIN, where the
    wrapper's rule takes the panel kernel.  Each checked call, launch
    counts and panel counters read just before, must launch ``ell_spmm``
    once, count one panel launch and its F / P panels, and equal the
    plain version bit for bit; then its time beside the same kernel in
    row order (P = F), the plain version's, the bound (each B row the
    live slots name read once), one B row a live slot (no reuse in any
    cache) and, for f32, ``torch.sparse.mm`` on the same live slots."""
    torch, ops, obs, ell_mod = P.torch, P.ops, P.obs, P.ell_mod
    ell = ops.aes_sample(panel_graph(P, device), W_MAIN)
    live = ell.live_w
    rows, feat = PANEL_ROWS, PANEL_FEAT
    n_live = int(live.sum())
    live_mask = torch.arange(W_MAIN, device=device)[None, :] < live[:, None]
    uniq = int(torch.unique(ell.col[live_mask]).numel())
    crow = torch.zeros(rows + 1, dtype=torch.int64, device=device)
    crow[1:] = torch.cumsum(live.long(), 0)
    a_sparse = torch.sparse_csr_tensor(crow, ell.col[live_mask].long(),
                                       ell.val[live_mask], (rows, rows))
    del live_mask
    x = torch.randn((rows, feat), generator=torch.Generator(
        device=device).manual_seed(37), device=device)
    qf = P.quantize(x, 8)
    l2 = torch.cuda.get_device_properties(device).L2_cache_size
    reg = obs.default_registry()
    counters = ("kernels.ell_spmm.panel_launches", "kernels.ell_spmm.panels")
    ell_in = n_live * 8 + rows * 4                # live (val, col) + live_w
    out = {"shape": {"rows": rows, "W": W_MAIN, "F": feat,
                     "live_slots": n_live, "distinct_b_rows": uniq,
                     "l2_bytes": l2}}
    prev = obs.set_enabled(True)
    try:
        for key, b, meta in (("f32", x, None),
                             ("u8", qf.q, (qf.scale, qf.x_min))):
            item = b.element_size()
            panel = ell_mod._panel_features(rows, feat, item, l2)
            if panel >= feat:
                raise AssertionError(
                    f"ell_spmm: the {key} operand [{rows}, {feat}] takes no "
                    f"panels on a card with {l2} bytes of L2")

            def fn(b=b, meta=meta):
                return ops.ell_spmm(ell, b, live, quantized_meta=meta)

            def plain(b=b, meta=meta):
                return ell_mod.ell_spmm_plain(ell.val, ell.col, live, b, meta)

            ops.reset_launch_counts()
            before = [reg.counter_value(c) for c in counters]
            got = fn()
            counted = [reg.counter_value(c) - n
                       for c, n in zip(counters, before)]
            launched = ops.launch_counts()["ell_spmm"]
            if launched != 1 or counted != [1, -(-feat // panel)]:
                raise AssertionError(
                    f"ell_spmm {key}: {launched} launches and panel counters "
                    f"{counted}, want 1 and [1, {-(-feat // panel)}]")
            want = plain()
            if not torch.equal(got, want):
                raise AssertionError(
                    f"ell_spmm {key} in panels of {panel} differs from its "
                    f"plain version: {float((got - want).abs().max())}")
            del got, want
            out[key] = {
                "panel": panel, "panels": counted[1], "launches": launched,
                "panel_launches": counted[0], "max_abs_err": 0.0,
                "ms": timer(fn),
                "row_order_ms": timer(lambda b=b, meta=meta: ell_mod._launch(
                    ell.val, ell.col, live, b, meta, feat)),
                "plain_ms": plain_timer(plain),
                "bound_ms": bound(ell_in + uniq * feat * item
                                  + rows * feat * 4, 2.0 * n_live * feat)[0],
                "gather_bound_ms": (ell_in + n_live * feat * item
                                    + rows * feat * 4)
                / HBM_BYTES_PER_S * 1e3,
                "library_ms": None if meta else timer(
                    lambda: torch.sparse.mm(a_sparse, x)),
                "host_ms": host_ms(torch, fn)}
    finally:
        obs.set_enabled(prev)
    log({"phase": "ell_panels", **out})
    return out


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
        "host_ms": host_ms(torch, lambda: kernel(x, w1, b1, True, None)),
        "layer2": {**layer2, "F": HIDDEN, "H": ds.spec.num_classes},
        "u8": layer1_u8,
        "shape": {"rows": rows, "W": W_MAIN, "F": feat, "H": HIDDEN,
                  "live_slots": n_live, "distinct_b_rows": uniq}}


def dequantize_entry(P, x, launches, errs, timer, plain_timer) -> dict:
    """Eq. 2 over the reddit features quantized to uint8 (and uint16), the
    constants and the output made once, outside every timed call: ``ms``
    is the kernel's own device time a launch (:func:`kernel_own_ms`, read
    as ``ms_from`` says), ``events_ms`` the CUDA-event time of the
    wrapper's calls (:func:`time_ms`), ``host_ms`` the host's time a call;
    ``events_ms_setup_each_call`` times calls that compute ``scale`` (a
    subtract and a divide) and allocate the output each time, as earlier
    runs timed them.  The library call is ``torch.addcmul(x_min, q,
    scale)``, Eq. 2 in one call (it may contract into FMA: its largest
    difference from the kernel is logged)."""
    torch, ops = P.torch, P.ops
    n = x.numel()
    out = {}
    for bits in (8, 16):
        qf = P.quantize(x, bits)
        q, scale, x_min = qf.q, qf.scale, qf.x_min
        dst = torch.empty(q.shape, dtype=torch.float32, device=q.device)

        def fn():
            return ops.dequantize(q, scale, x_min, bits=bits, out=dst)

        def pl():
            return P.dequant_mod.dequantize_plain(q, scale, x_min)

        def lib():
            return torch.addcmul(x_min, q, scale)

        if not torch.equal(fn(), pl()):
            raise AssertionError(f"dequantize differs at bits={bits}")
        errs["dequantize"].append(0.0)
        own, how, _ = kernel_own_ms(torch, fn, DEQUANT_KERNEL)
        t_bound, by = bound(n * (bits // 8) + n * 4, 2.0 * n)
        out[bits] = {
            "ms": own, "ms_from": how, "events_ms": timer(fn),
            "host_ms": host_ms(torch, fn),
            "events_ms_setup_each_call": timer(lambda: ops.dequantize(
                qf.q, qf.scale, qf.x_min, bits=bits)),
            "plain_ms": plain_timer(pl), "bound_ms": t_bound,
            "bound_by": by, "share_of_bound": t_bound / own,
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
    from repro_torch.core.aes_spmm import aes_spmm, sample
    from repro_torch.core.graph import (CSR, ELL, apply_csr_deltas,
                                        csr_block_digests, csr_from_edges,
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
    from repro_torch.serving import (GNNServer, ServingRuntime,
                                     run_open_loop, sync_baseline)
    from repro_torch.tuning import (PlanCache, apply_edge_updates,
                                    features_fingerprint, fingerprint,
                                    tune_blocked)
    from repro_torch.configs import ALL_ARCHS, get_config, smoke_config
    from repro_torch.launch.serve import grow_cache, prefill, serve
    from repro_torch.models import (decode_step, forward, init_cache,
                                    init_params)
    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.checkpoint.checkpointer import flatten
    from repro_torch.data import make_pipeline
    from repro_torch.distributed.sharding import place
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import main as train_main
    from repro_torch.launch.train import (make_train_step, sharded_step,
                                          state_shardings)
    from repro_torch.optim import adamw_init, constant, cosine_with_warmup
    from repro_torch.runtime import (FaultTolerantRunner, RunnerConfig,
                                     SimulatedFailure)

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
    incremental = incremental_path(P, ds)
    if incremental["block_ell_spmm"] <= 0:
        raise AssertionError("kernel block_ell_spmm was not launched on "
                             "the incremental path")
    import tempfile

    with tempfile.TemporaryDirectory() as cache_root:
        serving = serving_path(P, ds, modules, full_acc, Path(cache_root))
        spmd = serving_spmd_path(P, ds, Path(cache_root))
        spmd_slots = serving_spmd_slots_path(P, ds, Path(cache_root))
    clis = cli_smokes(P)
    lm = lm_serve_path(P)
    lm_pattern = lm_pattern_serve_path(P)
    lm_train = lm_train_path(P)
    lm_mesh_path()
    lm_dryrun_path()
    launches = {k: n + presampled[k] + tuned[k] + incremental[k] + serving[k]
                + spmd[k] + spmd_slots[k] + clis[k] + lm[k] + lm_pattern[k]
                + lm_train[k]
                for k, n in launches.items()}

    errs["fused_layer_int8"] = []
    int8_layers(P, ds, device, errs)

    # -- 5. kernel times at the main path's shapes --------------------------
    timer = functools.partial(time_ms, torch)
    plain_timer = functools.partial(time_ms, torch, batch=1, reps=PLAIN_REPS,
                                    warmup=1)
    kernels, hidden = kernel_times(P, ds, device, launches, errs, timer,
                                   plain_timer)
    kernels[0]["f602"] = ell_panel_entry(P, device, timer, plain_timer)
    kernels.append(block_entry(P, ds, plan, hidden, launches, errs, timer,
                               plain_timer, kernels[0]["ms"]))
    torch.cuda.synchronize()
    log({"phase": "done", "wall_s": time.perf_counter() - t_start})

    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:] == ["--lm-mesh"]:
        lm_mesh_child()
    else:
        main()
