"""The benchmark's graph and feature generator, on the device, from a seed.

A graph of a configuration is drawn at its published node count and its
published count of directed edges, exactly:

  * heavy-tailed degrees: each node gets a lognormal weight (``sigma`` from
    the configuration), and each undirected edge picks its endpoints with
    probability proportional to those weights (Chung-Lu), so a node's
    expected degree is proportional to its weight;
  * planted communities: ``classes`` contiguous id blocks; with
    probability ``homophily`` an edge's second endpoint is drawn from the
    first one's community, else from the whole graph;
  * a simple symmetric graph: self loops and repeated pairs are dropped,
    and rounds of further draws fill the count up; a seeded random subset
    trims the last round's surplus.  Degrees are then at most n - 1;
  * node order: every id goes through a seeded random permutation, so the
    gathers see the locality of a graph stored in arbitrary order.

Features: one N(0, 1) mean a community plus N(0, ``feat_noise``^2) noise a
node, as float32.  Everything is drawn with one ``torch.Generator`` on the
device, in a fixed order, so one seed gives the same arrays in every run.
"""
from __future__ import annotations

import math
import zlib
from typing import NamedTuple

import torch

from bench.reference import aes

#: Rounds of draws before the generator gives up on a too dense graph.
MAX_ROUNDS = 64


class Graph(NamedTuple):
    """A generated graph in CSR form (rows sorted, columns sorted within a
    row), with the model's normalized edge values."""

    row_ptr: torch.Tensor   # int32[n + 1]
    col: torch.Tensor       # int32[nnz]
    val: torch.Tensor       # float32[nnz]
    labels: torch.Tensor    # int32[n]: the planted community of each node
    edges: int              # directed edges of the graph, self loops excluded
    stats: dict             # what the generator realized (logged every run)


def generator(seed: int, salt: str, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from ``seed`` (any whole
    number) and ``salt`` (a configuration's name), so two configurations
    never share a stream."""
    g = torch.Generator(device=device)
    mixed = (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(salt.encode()))
    g.manual_seed(mixed % 2**64)
    return g


def _draw_pairs(k, cum, comm, lo, hi, last, perm, n, homophily, g):
    """``k`` endpoint pairs, as canonical keys ``min * n + max`` of the
    permuted ids, self loops dropped."""
    dev = cum.device
    total = cum[-1]
    r = torch.rand(k, generator=g, device=dev, dtype=torch.float64)
    u = torch.searchsorted(cum, r * total, right=True).clamp_(max=n - 1)
    c = comm[u]
    intra = torch.rand(k, generator=g, device=dev) < homophily
    r = torch.rand(k, generator=g, device=dev, dtype=torch.float64)
    t = torch.where(intra, lo[c] + r * (hi[c] - lo[c]), r * total)
    v = torch.searchsorted(cum, t, right=True)
    v = torch.where(intra, torch.minimum(v, last[c]), v.clamp_(max=n - 1))
    a, b = perm[u], perm[v]
    keep = a != b
    a, b = a[keep], b[keep]
    return torch.minimum(a, b) * n + torch.maximum(a, b)


def make_graph(cfg: dict, seed: int, device, *, self_loops: bool,
               norm: str) -> Graph:
    """The graph of configuration ``cfg`` (``nodes``, ``edges`` directed,
    ``classes``, ``degree_sigma``, ``homophily``, ``sh_width``) for
    ``seed``, on ``device``.

    ``self_loops`` adds ``I`` to the adjacency; ``norm`` sets the values:
    ``"sym"`` is D^-1/2 A D^-1/2 with D the row sums of the adjacency as
    built (GCN's normalization when ``self_loops``), ``"mean"`` is D^-1 A
    (GraphSAGE's mean aggregator; empty rows stay empty).
    """
    n, m = int(cfg["nodes"]), int(cfg["edges"])
    if m % 2:
        raise ValueError(f"a symmetric graph has an even edge count, not {m}")
    pairs = m // 2
    if pairs > n * (n - 1) // 4:
        raise ValueError(f"{m} edges on {n} nodes is too dense to draw")
    classes = int(cfg["classes"])
    g = generator(seed, cfg["name"], device)

    w = torch.randn(n, generator=g, device=device, dtype=torch.float64)
    w = torch.exp(w * float(cfg["degree_sigma"]))
    cum = torch.cumsum(w, 0)
    ids = torch.arange(n, device=device)
    comm = ids * classes // n
    start = torch.searchsorted(comm, torch.arange(classes, device=device))
    last = torch.cat([start[1:], start.new_tensor([n])]) - 1
    lo = torch.where(start > 0, cum[(start - 1).clamp(min=0)],
                     torch.zeros_like(cum[:classes]))
    hi = cum[last]
    perm = torch.randperm(n, generator=g, device=device)

    keys = torch.empty(0, dtype=torch.int64, device=device)
    draw, rounds = pairs, 0
    while keys.numel() < pairs:
        if rounds == MAX_ROUNDS:
            raise RuntimeError(f"{rounds} rounds drew {keys.numel()} of "
                               f"{pairs} distinct pairs")
        before = keys.numel()
        new = _draw_pairs(draw, cum, comm, lo, hi, last, perm, n,
                          float(cfg["homophily"]), g)
        keys = torch.unique(torch.cat([keys, new]))
        rounds += 1
        gained = max(keys.numel() - before, 1)
        draw = math.ceil((pairs - keys.numel()) * draw / gained * 1.05) + 64
    if keys.numel() > pairs:
        pick = torch.randperm(keys.numel(), generator=g, device=device)
        keys = keys[pick[:pairs]]

    a, b = keys // n, keys % n
    del keys
    directed = [a * n + b, b * n + a]
    if self_loops:
        directed.append(ids * (n + 1))
    flat = torch.sort(torch.cat(directed)).values
    del directed, a, b
    row, col = flat // n, (flat % n).to(torch.int32)
    del flat
    counts = torch.bincount(row, minlength=n)
    row_ptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    deg = counts.to(torch.float64)
    if norm == "sym":
        inv = deg.clamp(min=1).rsqrt()
        val = (inv[row] * inv[col.long()]).to(torch.float32)
    elif norm == "mean":
        val = (1.0 / deg.clamp(min=1))[row].to(torch.float32)
    else:
        raise ValueError(f"unknown normalization {norm!r}")
    labels = torch.empty(n, dtype=torch.int32, device=device)
    labels[perm] = comm.to(torch.int32)
    off_diag = row != col
    same = labels[row[off_diag]] == labels[col[off_diag].long()]
    del row, off_diag
    raw_deg = counts - int(self_loops)
    width = int(cfg["sh_width"])
    w_row = counts.clamp(max=width)
    band = sum((counts > t * w_row).long() for t in aes.THRESHOLDS)
    stats = {
        "nodes": n,
        "edges_published": m,
        "edges_realized": int(raw_deg.sum()),
        "adjacency_nnz": int(col.numel()),
        "max_degree": int(raw_deg.max()),
        "max_degree_published": cfg.get("published", {}).get("max_degree"),
        "rows_by_band": torch.bincount(band, minlength=5).tolist(),
        "rows_above_w": float((counts > width).double().mean()),
        "live_slots": int(counts.clamp(max=width).sum()),
        "homophily_realized": float(same.double().mean()),
        "draw_rounds": rounds,
    }
    return Graph(row_ptr.to(torch.int32), col, val, labels, m, stats)


def make_features(cfg: dict, labels: torch.Tensor, seed: int, count: int,
                  device) -> list:
    """``count`` float32 feature matrices ``[nodes, features]``: the
    community's mean plus noise, each with its own noise draw."""
    g = generator(seed, cfg["name"] + ".features", device)
    n, f = labels.numel(), int(cfg["features"])
    means = torch.randn(int(cfg["classes"]), f, generator=g, device=device)
    rows = means[labels.long()]
    pool = []
    for _ in range(count):
        x = torch.randn(n, f, generator=g, device=device)
        pool.append(x.mul_(float(cfg["feat_noise"])).add_(rows))
    return pool


def make_params(shapes: dict, seed: int, salt: str, device) -> dict:
    """Glorot-uniform float32 weights for every 2-D shape and uniform
    biases in [-0.1, 0.1) for every 1-D one, drawn in ``shapes``' order."""
    g = generator(seed, salt + ".params", device)
    out = {}
    for name, shape in shapes.items():
        bound = (math.sqrt(6.0 / (shape[0] + shape[1])) if len(shape) == 2
                 else 0.1)
        u = torch.rand(*shape, generator=g, device=device)
        out[name] = u.mul_(2 * bound).sub_(bound)
    return out
