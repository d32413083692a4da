"""GCN (Kipf & Welling) and GraphSAGE (mean aggregator) — the paper's two
evaluation models (§4.1) — as ``nn.Module``s with the aggregation step
pluggable, so inference can swap the exact, sampled and fused kernels.

Aggregation signature: ``agg(csr, h) -> h'``, the SpMM ``F = A @ H`` of
paper §2.1.  Parameter names are the reference package's
(``w1, b1, w2, b2``; ``w_self1, w_neigh1, b1, w_self2, w_neigh2, b2``).
Dense transforms are ``torch.matmul``, as the reference leaves them to
XLA.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.core.graph import CSR
from repro_torch.kernels import ref

AggFn = Callable[[CSR, torch.Tensor], torch.Tensor]


def exact_agg(csr: CSR, h: torch.Tensor) -> torch.Tensor:
    """cuSPARSE-role aggregation (no sampling, exact)."""
    return ref.csr_spmm(csr.row_ptr, csr.col_ind, csr.val, h)


def make_sampled_agg(sh_width: int, strategy: str = "aes",
                     backend: str = "torch", quantized=None) -> AggFn:
    from repro_torch.core.aes_spmm import aes_spmm

    def agg(csr: CSR, h: torch.Tensor) -> torch.Tensor:
        return aes_spmm(csr, h, sh_width, strategy=strategy, backend=backend,
                        quantized=quantized)

    return agg


def make_presampled_agg(csr: CSR, sh_width: int, strategy: str = "aes",
                        backend: str = "torch", *, device=None) -> AggFn:
    """Sample ``csr`` once and reuse the ELL on every call (the paper's
    kernel resamples on every SpMM).

    ``backend="torch"`` aggregates through ``ref.ell_spmm_rowloop``;
    ``"cuda"`` samples with the ``aes_sample`` kernel (AES; AFS and SFS
    sample in torch) and aggregates with the ``ell_spmm`` kernel on the
    sampler's live widths.  ``csr`` is copied to ``device`` (default
    ``"cuda"``), where the ELL lives; the returned ``agg(_csr, h)``
    ignores its CSR argument.
    """
    from repro_torch.core.aes_spmm import sample

    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r} (expected 'torch' "
                         "or 'cuda')")
    ell = sample(csr.to(resolve_device(device)), sh_width, strategy,
                 backend=backend)

    def agg(_csr: CSR, h: torch.Tensor) -> torch.Tensor:
        if backend == "cuda":
            from repro_torch.kernels import ops

            return ops.ell_spmm(ell, h)
        return ref.ell_spmm_rowloop(ell.val, ell.col, h)

    return agg


class GCNParams(NamedTuple):
    """The reference package's GCN parameters, by field name (what
    ``convert.params_from_numpy`` takes; :class:`GCN` holds the same
    names as its parameters)."""
    w1: np.ndarray
    b1: np.ndarray
    w2: np.ndarray
    b2: np.ndarray


class SAGEParams(NamedTuple):
    """The reference package's GraphSAGE parameters, by field name (see
    :class:`GCNParams`)."""
    w_self1: np.ndarray
    w_neigh1: np.ndarray
    b1: np.ndarray
    w_self2: np.ndarray
    w_neigh2: np.ndarray
    b2: np.ndarray


def _params(**tensors) -> dict:
    return {k: nn.Parameter(torch.tensor(np.asarray(v), dtype=torch.float32),
                            requires_grad=False)
            for k, v in tensors.items()}


class GCN(nn.Module):
    """2-layer GCN: ``A' relu(A' X W1 + b1) W2 + b2`` with A' normalized."""

    def __init__(self, w1, b1, w2, b2):
        super().__init__()
        for k, p in _params(w1=w1, b1=b1, w2=w2, b2=b2).items():
            self.register_parameter(k, p)

    def forward(self, adj: CSR, x: torch.Tensor,
                agg: AggFn = exact_agg) -> torch.Tensor:
        h = torch.relu(agg(adj, x) @ self.w1 + self.b1)
        return agg(adj, h) @ self.w2 + self.b2


class GraphSAGE(nn.Module):
    """2-layer GraphSAGE-mean: ``h' = relu(h W_self + mean_agg(h) W_neigh + b)``."""

    def __init__(self, w_self1, w_neigh1, b1, w_self2, w_neigh2, b2):
        super().__init__()
        for k, p in _params(w_self1=w_self1, w_neigh1=w_neigh1, b1=b1,
                            w_self2=w_self2, w_neigh2=w_neigh2,
                            b2=b2).items():
            self.register_parameter(k, p)

    def forward(self, adj: CSR, x: torch.Tensor,
                agg: AggFn = exact_agg) -> torch.Tensor:
        h = torch.relu(x @ self.w_self1 + agg(adj, x) @ self.w_neigh1
                       + self.b1)
        return h @ self.w_self2 + agg(adj, h) @ self.w_neigh2 + self.b2


def _glorot_like(rng: np.random.Generator, *shape) -> np.ndarray:
    return rng.normal(size=shape).astype(np.float32) / np.sqrt(shape[0])


def init_gcn(rng: np.random.Generator, feat: int, hidden: int, classes: int,
             *, device=None) -> GCN:
    """Random GCN from a numpy generator (the reference's draws, in order),
    on ``device`` (default ``"cuda"``)."""
    device = resolve_device(device)
    w1 = _glorot_like(rng, feat, hidden)
    w2 = _glorot_like(rng, hidden, classes)
    return GCN(w1, np.zeros(hidden, np.float32), w2,
               np.zeros(classes, np.float32)).to(device)


def init_sage(rng: np.random.Generator, feat: int, hidden: int, classes: int,
              *, device=None) -> GraphSAGE:
    """Random GraphSAGE from a numpy generator, on ``device`` (default
    ``"cuda"``)."""
    device = resolve_device(device)
    ws1, wn1 = _glorot_like(rng, feat, hidden), _glorot_like(rng, feat, hidden)
    ws2 = _glorot_like(rng, hidden, classes)
    wn2 = _glorot_like(rng, hidden, classes)
    return GraphSAGE(ws1, wn1, np.zeros(hidden, np.float32), ws2, wn2,
                     np.zeros(classes, np.float32)).to(device)


MODELS = {
    "gcn": (init_gcn, GCN, "gcn_adj"),
    "graphsage": (init_sage, GraphSAGE, "sage_adj"),
}
