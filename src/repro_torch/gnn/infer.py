"""GNN inference harness: evaluate a model under any SpMM backend, sampling
strategy, width W and quantization (paper §4.2 protocol)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import obs
from repro_torch._device import resolve_device
from repro_torch.core.aes_spmm import not_ported
from repro_torch.core.quantization import dequantize, quantize
from repro_torch.gnn.datasets import GraphDataset
from repro_torch.gnn.models import MODELS, exact_agg, make_sampled_agg
from repro_torch.gnn.train import accuracy


def infer_logits(ds: GraphDataset, model: str, params, *,
                 sh_width: int = 128, strategy: str = "aes",
                 backend: str = "torch",
                 quantize_bits: Optional[int] = None,
                 fuse_layers: bool = False,
                 device=None) -> torch.Tensor:
    """The logits :func:`evaluate` scores, f32[nodes, classes], computed on
    ``device`` (default ``"cuda"``); ``ds`` is copied there and the
    ``params`` module moved there in place.

    ``quantize_bits`` quantizes the input features (Eq. 1).  The
    ``"cuda"`` backend serves them through the int8 gather kernel and
    re-encodes the hidden layer with the stored range (float on drift);
    ``"torch"`` and ``"cuda_fused"`` aggregate the Eq. 2 reconstruction.
    ``fuse_layers=True`` (GCN, ``"torch"`` or ``"cuda"``) runs each layer
    as one fused step (see :func:`_fused_gcn_logits`).
    """
    if fuse_layers:
        _check_fused(model, strategy, backend)
    device = resolve_device(device)
    _, _, adj_name = MODELS[model]
    ds = ds.to(device)
    params = params.to(device)
    adj = getattr(ds, adj_name)
    feats = ds.features

    with torch.inference_mode():
        if fuse_layers:
            return _fused_gcn_logits(adj, feats, params, sh_width=sh_width,
                                     strategy=strategy, backend=backend,
                                     quantize_bits=quantize_bits)
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


def _check_fused(model: str, strategy: str, backend: str) -> None:
    """The reference package's checks of ``fuse_layers=True``; the tuned
    ``strategy="auto"`` is not ported yet."""
    if model != "gcn":
        raise ValueError(
            f"fuse_layers supports the 2-layer GCN forward only, not "
            f"{model!r} (GraphSAGE's concat-self transform is not fused)")
    if strategy == "auto":
        raise not_ported('strategy="auto"')
    if backend not in ("torch", "cuda"):
        raise ValueError(f"fuse_layers supports backends 'torch'/'cuda', "
                         f"not {backend!r}")


def _fused_gcn_logits(adj, feats, params, *, sh_width: int, strategy: str,
                      backend: str, quantize_bits: Optional[int]):
    """Forward pass for ``fuse_layers=True``: both GCN layers through
    ``PlanExecutor.run_fused_layer`` over one sampled operand (the
    ``aes_sample`` kernel on ``"cuda"``).

    Mirrors the unfused semantics: the features are quantized once and
    layer 1 runs on their Eq. 2 reconstruction (the int8 gather on
    ``"cuda"``); layer 2 feeds the hidden activation back with the range
    guard — in-range activations re-encode against the stored
    ``(x_min, x_max)``, drifted ones take the float path.
    """
    from repro_torch.core.aes_spmm import sample
    from repro_torch.exec import PlanExecutor

    executor = PlanExecutor()
    qf = None
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
             device=None) -> float:
    """Test accuracy under the given kernel configuration, computed on
    ``device`` (default ``"cuda"``; a missing card raises).

    Args:
      ds: the dataset; model: "gcn" | "graphsage"; params: the model
        module (``MODELS[model][0]`` or ``convert.params_from_numpy``).
      sh_width / strategy: sampling width and "aes" | "afs" | "sfs" |
        "full".
      backend: "torch" | "cuda" | "cuda_fused".
      quantize_bits: None or 8 (16 works too).
      fuse_layers: GCN only, backends "torch" | "cuda": each layer —
        aggregation, dense transform, activation — as one fused step
        through ``exec.PlanExecutor.run_fused_layer`` (one kernel launch
        per layer on ``"cuda"``: the aggregation never reaches device
        memory).  Quantized inputs serve the fused int8 gather;
        hidden-layer activations re-quantize within the stored range or
        take the float path on range drift.

    ``strategy="auto"``, ``granularity="block"`` and ``shards=`` come with
    later slices and raise ``NotImplementedError``; with
    ``fuse_layers=True``, ``shards=``, ``granularity="block"``, GraphSAGE
    and ``"cuda_fused"`` raise ``ValueError``, as in the reference.
    """
    if shards is not None:
        if fuse_layers:
            raise ValueError("fuse_layers is a single-device path "
                             "(incompatible with shards=)")
        raise not_ported("shards=", "serving")
    if granularity != "graph":
        if fuse_layers:
            raise ValueError('fuse_layers requires granularity="graph" '
                             "(a fused layer runs one global ELL operand)")
        raise not_ported(f"granularity={granularity!r}")
    with obs.trace("gnn.evaluate", model=model, strategy=strategy,
                   backend=backend, granularity=granularity,
                   shards=shards or 0, fuse_layers=fuse_layers,
                   quant_bits=quantize_bits or 0) as sp:
        logits = infer_logits(ds, model, params, sh_width=sh_width,
                              strategy=strategy, backend=backend,
                              quantize_bits=quantize_bits,
                              fuse_layers=fuse_layers, device=device)
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
