"""CLI driver for the sharded serving engine.

    python -m repro_torch.serving.server --smoke [--device cpu]
    python -m repro_torch.serving.server --dataset cora --shards 4 --quant

``--smoke`` builds a small synthetic graph, serves it through a 4-shard
:class:`~repro_torch.serving.GNNServer` in loop mode (the reference's spmd
mode comes with the multi-card slice of the port, and the report says
so), and asserts

  * float-plan parity with the exact single-device CSR SpMM,
  * quantized-plan parity within the per-shard quantization bound,
  * that a second server over the same disk cache re-tunes nothing
    (every shard plan is a disk hit).

Everything runs on ``--device`` (default ``cuda``).
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.serving.engine import GNNServer
from repro_torch.tuning.plan_cache import PlanCache


def _quant_atol(server: GNNServer, csr) -> float:
    """Loose bound on the quantized-vs-float output gap: worst per-element
    reconstruction error (scale/2, per shard) times the largest absolute
    row weight sum of the adjacency."""
    rp = csr.row_ptr.cpu().numpy()
    rows = np.repeat(np.arange(csr.num_rows), rp[1:] - rp[:-1])
    rowsum = np.bincount(rows, weights=np.abs(csr.val.cpu().numpy()),
                         minlength=csr.num_rows)
    max_scale = max(float(p.quantized.scale) for p in server.plans)
    return 0.5 * max_scale * float(rowsum.max(initial=0.0)) + 1e-5


def _smoke(args: argparse.Namespace) -> dict:
    from repro_torch.gnn.datasets import make_dataset
    from repro_torch.kernels import ref

    dev = args.device
    ds = make_dataset("cora", scale=0.08, seed=0, device=dev)
    csr, feats = ds.gcn_adj, ds.features
    shards = args.shards
    # No-truncation tuning knobs: every candidate keeps all edges, so the
    # float engine must match the exact SpMM (the machinery under test is
    # partition/halo/dispatch, not sampling loss).
    w_full = int(csr.row_nnz().max())
    tk = dict(widths=(w_full,), include_full=True,
              measure_plan=False, warmup=0, iters=1)
    want = ref.csr_spmm(csr.row_ptr, csr.col_ind, csr.val, feats)

    def close(got, ref_, tol=1e-5):
        torch.testing.assert_close(got, ref_, rtol=tol, atol=tol)

    report: dict = {"device": str(dev), "shards": shards,
                    "nodes": csr.num_rows, "edges": csr.nnz,
                    "modes": ["loop"],
                    "spmd": "not ported (the multi-card slice)"}

    with tempfile.TemporaryDirectory() as cache_dir:
        server = GNNServer(csr, feats, num_shards=shards,
                           cache=PlanCache(cache_dir), tune_kwargs=tk,
                           devices=[dev])
        close(server.aggregate(), want)
        # micro-batch: two float requests in one flush
        t1 = server.submit(feats)
        t2 = server.submit(feats * 2.0)
        r = server.flush()
        close(r[t1], want)
        close(r[t2], want * 2.0)
        report["parity_loop"] = "ok"
        report["halo_loop"] = server.halo_stats()["halo_expansion"]

        # quantized plans: within the quantization bound (own cache dir,
        # inside the tempdir so it is cleaned up with it)
        qcache = PlanCache(str(Path(cache_dir) / "q"))
        qserver = GNNServer(csr, feats, num_shards=shards, quant=8,
                            cache=qcache, tune_kwargs=tk, devices=[dev])
        err = float((qserver.aggregate() - want).abs().max())
        atol = _quant_atol(qserver, csr)
        assert err <= atol, \
            f"quantized output off by {err} (bound {atol})"
        report["parity_quant"] = "ok"

        # warm restart: a fresh cache over the same dir must re-tune
        # nothing — every shard plan is a disk hit.
        warm = PlanCache(cache_dir)
        t0 = time.perf_counter()
        GNNServer(csr, feats, num_shards=shards, cache=warm, tune_kwargs=tk,
                  devices=[dev])
        report["warm_restart_us"] = round((time.perf_counter() - t0) * 1e6, 1)
        assert warm.stats.misses == 0 and warm.stats.disk_hits == shards, \
            f"warm restart re-tuned: {warm.stats}"
        report["warm_disk_hits"] = warm.stats.disk_hits

    print(json.dumps(report, indent=None if args.json else 2))
    print("smoke: OK")
    return report


def _run(args: argparse.Namespace) -> dict:
    from repro_torch.gnn.datasets import SYNTHETIC_DATASETS, make_dataset
    from repro_torch.serving.traffic import synchronize

    if args.dataset not in SYNTHETIC_DATASETS:
        raise SystemExit(
            f"unknown dataset {args.dataset!r}; choose from: "
            + ", ".join(sorted(SYNTHETIC_DATASETS)))
    ds = make_dataset(args.dataset, scale=args.scale, seed=args.seed,
                      device=args.device)
    csr = ds.gcn_adj
    cache = PlanCache(args.cache_dir) if args.cache_dir else PlanCache()
    t0 = time.perf_counter()
    server = GNNServer(csr, ds.features, num_shards=args.shards,
                       mode=args.mode, quant=8 if args.quant else None,
                       cache=cache, devices=[args.device])
    build_us = (time.perf_counter() - t0) * 1e6

    for _ in range(args.batch):
        server.submit()
    t0 = time.perf_counter()
    synchronize(server.flush())
    flush_us = (time.perf_counter() - t0) * 1e6
    rows = csr.num_rows * args.batch

    report = {
        "dataset": args.dataset,
        "nodes": csr.num_rows,
        "edges": csr.nnz,
        "device": str(server.device),
        "shards": server.num_shards,
        "mode": server.mode,
        "build_us": round(build_us, 1),
        "batch": args.batch,
        "flush_us": round(flush_us, 1),
        "rows_per_s": round(rows / max(flush_us / 1e6, 1e-9), 1),
        "halo": server.halo_stats(),
        "plans": server.plan_summary(),
        "cache": {"hits": cache.stats.hits, "misses": cache.stats.misses},
    }
    print(json.dumps(report, indent=None if args.json else 2))
    return report


def main(argv: Sequence[str] | None = None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.serving.server",
        description="Sharded, batched GNN inference serving over "
                    "per-shard plans.")
    p.add_argument("--dataset", default="cora")
    p.add_argument("--scale", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--shards", type=int, default=4)
    p.add_argument("--mode", choices=("loop", "spmd"), default="loop")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--quant", action="store_true",
                   help="serve uint8 per-shard operands (fused dequant)")
    p.add_argument("--batch", type=int, default=4,
                   help="requests per flush in the throughput report")
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--smoke", action="store_true",
                   help="parity + warm-restart gate")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    args.device = resolve_device(args.device)
    if args.smoke:
        _smoke(args)
    else:
        _run(args)


if __name__ == "__main__":
    main()
