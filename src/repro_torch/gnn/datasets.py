"""Synthetic benchmark graphs matching the paper's Table 2 statistics.

Each of the six datasets is a stochastic-block-model generator whose
(nodes, avg degree, degree skew) match Table 2 (scale=1.0 gives the
published node counts).  Class structure is planted (community-correlated
edges + class-mean features) so GNN accuracy is a meaningful signal.

The generator is the reference package's numpy code, draw for draw, so the
same ``(name, scale, seed, min_nodes, max_avg_degree)`` gives byte-identical
arrays in both packages.

| name            | nodes     | avg deg | skew        | classes |
|-----------------|-----------|---------|-------------|---------|
| cora            | 2,708     | 3.9     | low         | 7       |
| pubmed          | 19,717    | 4.5     | low         | 3       |
| ogbn-arxiv      | 169,343   | 13.7    | medium      | 40      |
| reddit          | 232,965   | 493.0   | heavy       | 41      |
| ogbn-proteins   | 132,534   | 597.0   | heavy       | 2       |
| ogbn-products   | 2,449,029 | 50.5    | heavy       | 47      |
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.graph import (CSR, csr_from_edges, gcn_normalize,
                                    mean_normalize)


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    nodes: int
    avg_degree: float
    skew: float              # pareto shape; smaller = heavier tail
    num_classes: int
    feat_dim: int
    large: bool              # paper's small/large split
    homophily: float = 0.82  # fraction of edges within community
    feat_noise: float = 2.5  # node-feature noise scale (aggregation-sensitive)


SYNTHETIC_DATASETS = {
    "cora": DatasetSpec("cora", 2708, 3.9, 0.0, 7, 96, large=False),
    "pubmed": DatasetSpec("pubmed", 19717, 4.5, 0.0, 3, 128, large=False),
    "ogbn-arxiv": DatasetSpec("ogbn-arxiv", 169343, 13.7, 1.6, 40, 128, large=False),
    "reddit": DatasetSpec("reddit", 232965, 493.0, 0.8, 41, 128, large=True),
    "ogbn-proteins": DatasetSpec("ogbn-proteins", 132534, 597.0, 0.7, 2, 128, large=True),
    "ogbn-products": DatasetSpec("ogbn-products", 2449029, 50.5, 0.9, 47, 100, large=True),
}


class GraphDataset(NamedTuple):
    spec: DatasetSpec
    csr: CSR                   # raw adjacency (unnormalized)
    gcn_adj: CSR               # D^-1/2 (A+I) D^-1/2
    sage_adj: CSR              # D^-1 A
    features: torch.Tensor     # f32[nodes, feat]
    labels: torch.Tensor       # int32[nodes]
    train_mask: torch.Tensor   # bool[nodes]
    test_mask: torch.Tensor    # bool[nodes]

    def to(self, device) -> "GraphDataset":
        return GraphDataset(
            self.spec, self.csr.to(device), self.gcn_adj.to(device),
            self.sage_adj.to(device), self.features.to(device),
            self.labels.to(device), self.train_mask.to(device),
            self.test_mask.to(device))


def make_dataset(name: str, scale: float = 0.02, seed: int = 0,
                 min_nodes: int = 192, max_avg_degree: float | None = 64.0,
                 *, device=None) -> GraphDataset:
    """Generate a scaled instance of a Table-2 dataset on ``device``
    (default ``"cuda"``).

    ``scale`` multiplies the node count; ``max_avg_degree`` caps the average
    degree (``None`` keeps the published one).
    """
    device = resolve_device(device)
    spec = SYNTHETIC_DATASETS[name]
    # zlib.crc32, not hash(): str hashes are process-salted
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 2**16)
    n = max(int(spec.nodes * scale), min_nodes)
    avg_deg = spec.avg_degree
    if max_avg_degree is not None:
        avg_deg = min(avg_deg, max_avg_degree)

    classes = spec.num_classes
    # contiguous community blocks: CSR edge order is id-sorted and id
    # correlates with community, which is why SFS's first-W window is a
    # biased sample (paper §2.4)
    comm = (np.arange(n) * classes) // n

    # degree sequence: pareto tail for the large graphs, near-uniform else
    if spec.skew > 0:
        raw = rng.pareto(spec.skew, n) + 0.25
        deg = np.maximum((raw / raw.mean() * avg_deg).astype(np.int64), 1)
        deg = np.minimum(deg, n - 1)
    else:
        deg = np.maximum(rng.poisson(avg_deg, n), 1)

    # homophilous edges: in-community with prob h, else uniform random
    dst = np.repeat(np.arange(n), deg)
    m = len(dst)
    in_comm = rng.random(m) < spec.homophily
    rand_nodes = rng.integers(0, n, m)
    pools = [np.where(comm == c)[0] for c in range(classes)]
    pool_pick = np.empty(m, np.int64)
    for c in range(classes):
        sel = comm[dst] == c
        cnt = int(sel.sum())
        if cnt and len(pools[c]):
            pool_pick[sel] = pools[c][rng.integers(0, len(pools[c]), cnt)]
        else:
            pool_pick[sel] = rand_nodes[sel]
    src = np.where(in_comm, pool_pick, rand_nodes)

    csr = csr_from_edges(src, dst, n, device="cpu")

    # features: class means + strong noise, so accuracy depends on
    # neighbourhood aggregation
    means = rng.normal(size=(classes, spec.feat_dim)).astype(np.float32)
    feats = (means[comm] + rng.normal(
        scale=spec.feat_noise, size=(n, spec.feat_dim)).astype(np.float32))

    perm = rng.permutation(n)
    n_train = int(0.6 * n)
    train_mask = np.zeros(n, bool)
    train_mask[perm[:n_train]] = True

    return GraphDataset(
        spec=spec,
        csr=csr,
        gcn_adj=gcn_normalize(csr),
        sage_adj=mean_normalize(csr),
        features=torch.from_numpy(feats),
        labels=torch.from_numpy(comm.astype(np.int32)),
        train_mask=torch.from_numpy(train_mask),
        test_mask=torch.from_numpy(~train_mask),
    ).to(device)


def table2_stats(name: str) -> dict:
    """Published Table-2 statistics of ``name`` (nodes, average degree and
    the edge count they imply), with no graph built."""
    s = SYNTHETIC_DATASETS[name]
    return {"nodes": s.nodes, "avg_degree": s.avg_degree,
            "edges": int(s.nodes * s.avg_degree)}
