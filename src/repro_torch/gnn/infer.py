"""GNN inference harness: evaluate a model under any SpMM backend, sampling
strategy, width W and quantization (paper §4.2 protocol)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.core.quantization import dequantize, quantize
from repro_torch.gnn.datasets import GraphDataset
from repro_torch.gnn.models import MODELS, exact_agg, make_sampled_agg
from repro_torch.gnn.train import accuracy


def infer_logits(ds: GraphDataset, model: str, params, *,
                 sh_width: int = 128, strategy: str = "aes",
                 backend: str = "torch",
                 quantize_bits: Optional[int] = None,
                 granularity: str = "graph",
                 fuse_layers: bool = False,
                 shards: Optional[int] = None,
                 plan_cache=None, tune_kwargs=None,
                 device=None) -> torch.Tensor:
    """The logits :func:`evaluate` scores, f32[nodes, classes], computed on
    ``device`` (default ``"cuda"``); ``ds`` is copied there and the
    ``params`` module moved there in place.

    ``quantize_bits`` quantizes the input features (Eq. 1).  The
    ``"cuda"`` backend serves them through the int8 gather kernel and
    re-encodes the hidden layer with the stored range (float on drift);
    ``"torch"`` and ``"cuda_fused"`` aggregate the Eq. 2 reconstruction.
    ``strategy="auto"`` aggregates through tuned plans (see
    :func:`evaluate`).  ``fuse_layers=True`` (GCN) runs each layer as one
    fused step (see :func:`_fused_gcn_logits`).  ``shards=N`` aggregates
    through a sharded ``GNNServer`` (see :func:`_sharded_logits`).
    """
    if fuse_layers:
        if shards is not None:
            raise ValueError("fuse_layers is a single-device path "
                             "(incompatible with shards=)")
        _check_fused(model, strategy, backend, granularity)
    elif shards is not None:
        if strategy != "auto":
            raise ValueError("shards= requires strategy='auto' (per-shard "
                             "configs are the tuner's to pick)")
    elif granularity not in ("graph", "block"):
        raise ValueError(f"unknown granularity {granularity!r} "
                         "(expected 'graph' or 'block')")
    elif granularity != "graph" and strategy != "auto":
        # mirror aes_spmm: per-block configs are the tuner's to pick
        raise ValueError('granularity="block" requires strategy="auto"')
    device = resolve_device(device)
    _, _, adj_name = MODELS[model]
    ds = ds.to(device)
    params = params.to(device)
    adj = getattr(ds, adj_name)
    feats = ds.features

    with torch.inference_mode():
        if shards is not None:
            return _sharded_logits(adj, adj_name, feats, params, shards,
                                   quantize_bits=quantize_bits,
                                   plan_cache=plan_cache,
                                   tune_kwargs=tune_kwargs, device=device)
        if fuse_layers:
            return _fused_gcn_logits(adj, feats, params, sh_width=sh_width,
                                     strategy=strategy, backend=backend,
                                     quantize_bits=quantize_bits,
                                     plan_cache=plan_cache,
                                     tune_kwargs=tune_kwargs)
        if strategy == "auto":
            from repro_torch.core.aes_spmm import aes_spmm

            tk = dict(tune_kwargs or {})
            if granularity == "block" and quantize_bits is not None:
                tk.setdefault("quant", quantize_bits)

            def agg(csr, h):
                return aes_spmm(csr, h, strategy="auto",
                                granularity=granularity,
                                plan_cache=plan_cache,
                                tune_kwargs=tk or None)

            return params(adj, feats, agg)
        quantized = None
        if quantize_bits is not None:
            quantized = quantize(feats, quantize_bits)
            feats = dequantize(quantized)
        if strategy == "full":
            agg = exact_agg
        else:
            agg = make_sampled_agg(sh_width, strategy, backend,
                                   quantized if backend == "cuda" else None)
        return params(adj, feats, agg)


def _sharded_logits(adj, adj_name: str, feats, params, shards: int, *,
                    quantize_bits: Optional[int], plan_cache, tune_kwargs,
                    device):
    """Forward pass for ``shards=N``: every aggregation through a
    ``repro_torch.serving.GNNServer`` over an N-way row partition of
    ``adj`` on ``device`` (per-shard tuned plans, ``block_ell_spmm`` on the
    card).  ``quantize_bits`` pre-quantizes each shard's operand; the
    hidden layer takes the per-shard float path."""
    from repro_torch.serving import GNNServer

    server = GNNServer(adj, feats, num_shards=shards, quant=quantize_bits,
                       cache=plan_cache, tune_kwargs=tune_kwargs,
                       devices=[device])
    try:
        def agg(csr, h):
            if csr is not adj:
                raise ValueError(
                    "sharded evaluate: the server is partitioned over "
                    f"{adj_name}; a model aggregating another adjacency "
                    "needs its own GNNServer")
            # the server dedupes operands equal to its feature matrix onto
            # the cached (possibly quantized) fast path
            return server.aggregate(h)

        return params(adj, feats, agg)
    finally:
        server.close()


def _check_fused(model: str, strategy: str, backend: str,
                 granularity: str) -> None:
    """The reference package's checks of ``fuse_layers=True``."""
    if model != "gcn":
        raise ValueError(
            f"fuse_layers supports the 2-layer GCN forward only, not "
            f"{model!r} (GraphSAGE's concat-self transform is not fused)")
    if granularity != "graph":
        raise ValueError('fuse_layers requires granularity="graph" '
                         "(a fused layer runs one global ELL operand)")
    if strategy != "auto" and backend not in ("torch", "cuda"):
        raise ValueError(f"fuse_layers supports backends 'torch'/'cuda', "
                         f"not {backend!r}")


def _fused_gcn_logits(adj, feats, params, *, sh_width: int, strategy: str,
                      backend: str, quantize_bits: Optional[int],
                      plan_cache=None, tune_kwargs=None):
    """Forward pass for ``fuse_layers=True``: both GCN layers through
    ``PlanExecutor.run_fused_layer`` over one sampled operand.

    ``strategy="auto"`` reuses the tuned plan's ELL and its (hash-guarded)
    quantized operand on the plan's backend; manual strategies sample once
    (the ``aes_sample`` kernel on ``"cuda"``) and optionally quantize, and
    layer 1 runs on the Eq. 2 reconstruction (the int8 gather on
    ``"cuda"``).  Layer 2 feeds the hidden activation back with the range
    guard — in-range activations re-encode against the stored
    ``(x_min, x_max)``, drifted ones take the float path.
    """
    from repro_torch.exec import default_executor

    executor = default_executor()
    qf = None
    if strategy == "auto":
        from repro_torch.tuning.autotune import tune
        from repro_torch.tuning.plan_cache import features_fingerprint

        plan = tune(adj, feats, cache=plan_cache, **(tune_kwargs or {}))
        ell = plan.ell
        qf = plan.quantized
        if qf is not None and features_fingerprint(feats) != plan.features_fp:
            qf = None
        backend = plan.config.backend
    else:
        from repro_torch.core.aes_spmm import sample

        if quantize_bits is not None:
            qf = quantize(feats, quantize_bits)
            feats = dequantize(qf)
        ell = sample(adj, sh_width, strategy, backend=backend)
    h = executor.run_fused_layer(
        ell, feats, params.w1, params.b1, relu=True, backend=backend,
        quantized=qf, requant_guard=qf is not None)
    return executor.run_fused_layer(
        ell, h, params.w2, params.b2, relu=False, backend=backend,
        quantized=qf, requant_guard=qf is not None)


def evaluate(ds: GraphDataset, model: str, params, *, sh_width: int = 128,
             strategy: str = "aes", backend: str = "torch",
             quantize_bits: Optional[int] = None,
             granularity: str = "graph",
             shards: Optional[int] = None,
             fuse_layers: bool = False,
             plan_cache=None, tune_kwargs=None,
             device=None) -> float:
    """Test accuracy under the given kernel configuration, computed on
    ``device`` (default ``"cuda"``; a missing card raises).

    Args:
      ds: the dataset; model: "gcn" | "graphsage"; params: the model
        module (``MODELS[model][0]`` or ``convert.params_from_numpy``).
      sh_width / strategy: sampling width and "aes" | "afs" | "sfs" |
        "full" | "auto".
      backend: "torch" | "cuda" | "cuda_fused" (ignored for "auto").
      quantize_bits: None or 8 (16 works too).
      granularity: with ``strategy="auto"``, "graph" tunes one global
        config (``tuning.tune``) and "block" one per row block
        (``tuning.tune_blocked``, served by the blocked kernel on the
        card); ``quantize_bits`` then pre-quantizes the input features
        into the blocked plan, and hidden-layer activations take the float
        path through the plan's features-hash guard.  The first
        aggregation tunes and caches a plan for the adjacency; every later
        one (the second layer, repeated calls) is a cache hit.
      plan_cache / tune_kwargs: the auto mode's cache (default: the
        process-wide one) and tuner overrides (``block_rows``,
        ``widths``, ``layout``, ``budget``, ...).
      fuse_layers: GCN only, backends "torch" | "cuda": each layer —
        aggregation, dense transform, activation — as one fused step
        through ``exec.PlanExecutor.run_fused_layer`` (one kernel launch
        per layer on ``"cuda"``: the aggregation never reaches device
        memory).  Quantized inputs serve the fused int8 gather;
        hidden-layer activations re-quantize within the stored range or
        take the float path on range drift.

      shards: ``strategy="auto"`` only: every aggregation goes through
        a sharded ``repro_torch.serving.GNNServer`` over an N-way row
        partition of the adjacency — per-shard tuned plans served by the
        blocked kernel on the card, the same accuracy semantics.
        ``quantize_bits`` then pre-quantizes each shard's operand, and the
        hidden layer takes the per-shard float path.

    ``shards=`` with a strategy other than ``"auto"`` raises
    ``ValueError``, and so do, with ``fuse_layers=True``, ``shards=``,
    ``granularity="block"``, GraphSAGE and ``"cuda_fused"``, as in the
    reference.
    """
    with obs.trace("gnn.evaluate", model=model, strategy=strategy,
                   backend=backend, granularity=granularity,
                   shards=shards or 0, fuse_layers=fuse_layers,
                   quant_bits=quantize_bits or 0) as sp:
        logits = infer_logits(ds, model, params, sh_width=sh_width,
                              strategy=strategy, backend=backend,
                              quantize_bits=quantize_bits,
                              granularity=granularity,
                              fuse_layers=fuse_layers, shards=shards,
                              plan_cache=plan_cache,
                              tune_kwargs=tune_kwargs, device=device)
        acc = accuracy(logits, ds.labels.to(logits.device),
                       ds.test_mask.to(logits.device))
        sp.set(accuracy=round(acc, 4))
        return acc


def inference_accuracy(ds: GraphDataset, model: str, params,
                       strategies=("full", "aes", "afs", "sfs"),
                       widths=(16, 32, 64, 128, 256), backend="torch",
                       device=None):
    """Accuracy grid reproducing Fig. 6's sweep."""
    out = {}
    for s in strategies:
        if s == "full":
            out[("full", 0)] = evaluate(ds, model, params, strategy="full",
                                        device=device)
            continue
        for w in widths:
            out[(s, w)] = evaluate(ds, model, params, sh_width=w,
                                   strategy=s, backend=backend,
                                   device=device)
    return out
