"""``repro_torch.serving`` — sharded, batched GNN inference on per-shard
plans, the port of the reference package's ``repro.serving``.

  * ``partition`` — 1-D row partition of the CSR adjacency into shards
    with a local/halo column split and a halo feature-gather index per
    shard;
  * ``plans`` — per-shard tuning (``tune_blocked`` per shard) cached under
    the extended key ``(fingerprint, kind, shard_meta)``, so restarting the
    same serving topology is a pure plan-cache hit; incremental edge
    updates routed to the owning shards;
  * ``engine`` — :class:`GNNServer` with ``submit()``/``flush()``
    micro-batching, per-shard width-bucketed launches of the blocked
    kernel (loop mode, double-buffered operand gathers) or one stacked
    pass over every shard (spmd mode, one launch a global width bucket),
    uint8 feature dispatch when the plans are quantized, and the
    non-blocking ``run_batch()`` dispatch path;
  * ``runtime`` — :class:`ServingRuntime`: the async continuous-batching
    request loop (bounded queue with backpressure, size-or-deadline flush,
    two-slot pipeline on CUDA streams and events, graceful drain);
  * ``telemetry`` — per-request latency histograms (p50/p95/p99 per
    stage) and batch/queue counters;
  * ``traffic`` — open-loop Poisson traffic + the synchronous baseline;
  * ``server`` / ``runtime`` CLIs: ``python -m
    repro_torch.serving.server --smoke`` and ``python -m
    repro_torch.serving.runtime --smoke|--bench``.
"""
from repro_torch.serving.engine import GNNServer
from repro_torch.serving.partition import (CSRShard, concat_shard_outputs,
                                           halo_stats, partition_csr,
                                           row_bounds)
from repro_torch.serving.plans import plan_shard, plan_shards, shard_meta_for
from repro_torch.serving.runtime import (BackpressureError, RuntimeRequest,
                                         ServingRuntime)
from repro_torch.serving.telemetry import LatencyHistogram, Telemetry
from repro_torch.serving.traffic import (poisson_arrivals, run_open_loop,
                                         sync_baseline)

__all__ = [
    "BackpressureError", "CSRShard", "GNNServer", "LatencyHistogram",
    "RuntimeRequest", "ServingRuntime", "Telemetry",
    "concat_shard_outputs", "halo_stats", "partition_csr", "plan_shard",
    "plan_shards", "poisson_arrivals", "row_bounds", "run_open_loop",
    "shard_meta_for", "sync_baseline",
]
