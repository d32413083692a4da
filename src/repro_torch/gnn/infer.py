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
                 device=None) -> torch.Tensor:
    """The logits :func:`evaluate` scores, f32[nodes, classes], computed on
    ``device`` (default ``"cuda"``); ``ds`` is copied there and the
    ``params`` module moved there in place.

    ``quantize_bits`` quantizes the input features (Eq. 1).  The
    ``"cuda"`` backend serves them through the int8 gather kernel and
    re-encodes the hidden layer with the stored range (float on drift);
    ``"torch"`` and ``"cuda_fused"`` aggregate the Eq. 2 reconstruction.
    """
    device = resolve_device(device)
    _, _, adj_name = MODELS[model]
    ds = ds.to(device)
    params = params.to(device)
    adj = getattr(ds, adj_name)
    feats = ds.features

    quantized = None
    if quantize_bits is not None:
        quantized = quantize(feats, quantize_bits)
        feats = dequantize(quantized)

    if strategy == "full":
        agg = exact_agg
    else:
        agg = make_sampled_agg(sh_width, strategy, backend,
                               quantized if backend == "cuda" else None)
    with torch.inference_mode():
        return params(adj, feats, agg)


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

    ``strategy="auto"``, ``granularity="block"``, ``shards=`` and
    ``fuse_layers=True`` come with later slices and raise
    ``NotImplementedError``.
    """
    if granularity != "graph":
        raise not_ported(f"granularity={granularity!r}")
    if shards is not None:
        raise not_ported("shards=", "serving")
    if fuse_layers:
        raise not_ported("fuse_layers=True", "fused-layer")
    with obs.trace("gnn.evaluate", model=model, strategy=strategy,
                   backend=backend, granularity=granularity,
                   shards=shards or 0, fuse_layers=fuse_layers,
                   quant_bits=quantize_bits or 0) as sp:
        logits = infer_logits(ds, model, params, sh_width=sh_width,
                              strategy=strategy, backend=backend,
                              quantize_bits=quantize_bits, device=device)
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
