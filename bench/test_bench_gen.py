"""The generator: published counts scaled down, the same arrays from the
same seed, a simple symmetric graph, permuted ids, the normalizations."""
from __future__ import annotations

import pytest
import torch

from bench import gen
from bench.conftest import small

CPU = torch.device("cpu")


def _graph(name="gcn-reddit", seed=5, loops=True, norm="sym", **kw):
    return gen.make_graph(small(name, **kw), seed, CPU, self_loops=loops,
                          norm=norm)


@pytest.mark.parametrize("name,nodes,edges", [
    ("gcn-reddit", 2329, 1146158), ("graphsage-ogbn-products", 4898, 247436)])
def test_counts_scaled_from_the_published_ones(name, nodes, edges):
    """A hundredth (reddit) or a five-hundredth (products) of the published
    node count, at the published average degree: the counts come out
    exactly, and the log says so."""
    g = _graph(name, nodes=nodes, edges=edges, loops=False, norm="mean")
    assert g.row_ptr.numel() == nodes + 1
    assert int(g.row_ptr[-1]) == edges == g.col.numel()
    assert g.stats["nodes"] == nodes
    assert g.stats["edges_realized"] == g.stats["edges_published"] == edges
    assert g.stats["max_degree"] <= nodes - 1
    width = small(name)["sh_width"]
    deg = (g.row_ptr[1:] - g.row_ptr[:-1]).long()
    assert g.stats["live_slots"] == int(deg.clamp(max=width).sum())
    assert g.stats["rows_above_w"] == pytest.approx(
        float((deg > width).double().mean()))


def test_same_seed_same_arrays_other_seed_other_arrays():
    a, b, c = _graph(seed=7), _graph(seed=7), _graph(seed=8)
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    assert not torch.equal(a.col, c.col)
    fa = gen.make_features(small("gcn-reddit"), a.labels, 7, 2, CPU)
    fb = gen.make_features(small("gcn-reddit"), b.labels, 7, 2, CPU)
    assert all(torch.equal(x, y) for x, y in zip(fa, fb))
    assert not torch.equal(fa[0], fa[1])
    pa = gen.make_params({"w": (24, 64), "b": (64,)}, 7, "x", CPU)
    pb = gen.make_params({"w": (24, 64), "b": (64,)}, 7, "x", CPU)
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert float(pa["w"].abs().max()) <= (6 / 88) ** 0.5
    assert float(pa["b"].abs().max()) <= 0.1


def test_large_seeds_are_taken():
    g = _graph(seed=2**31 + 12345)
    h = _graph(seed=-(2**31) - 3)
    assert g.stats["edges_realized"] == h.stats["edges_realized"]


def test_simple_symmetric_graph_with_self_loops_for_gcn():
    g = _graph(loops=True, norm="sym")
    n = g.row_ptr.numel() - 1
    rows = torch.repeat_interleave(torch.arange(n),
                                   (g.row_ptr[1:] - g.row_ptr[:-1]).long())
    keys = rows * n + g.col.long()
    assert torch.equal(keys, torch.sort(keys).values)       # CSR order
    assert torch.unique(keys).numel() == keys.numel()       # no repeats
    flipped = torch.sort(g.col.long() * n + rows).values
    assert torch.equal(flipped, keys)                        # symmetric
    assert int((rows == g.col.long()).sum()) == n            # A + I
    deg = torch.bincount(rows, minlength=n).double()
    want = (deg[rows] * deg[g.col.long()]).rsqrt().float()
    assert torch.allclose(g.val, want)


def test_mean_normalization_and_no_self_loops_for_graphsage():
    g = _graph("graphsage-ogbn-products", loops=False, norm="mean")
    n = g.row_ptr.numel() - 1
    rows = torch.repeat_interleave(torch.arange(n),
                                   (g.row_ptr[1:] - g.row_ptr[:-1]).long())
    assert int((rows == g.col.long()).sum()) == 0
    sums = torch.zeros(n, dtype=torch.float64).index_add_(
        0, rows, g.val.double())
    nonempty = g.row_ptr[1:] > g.row_ptr[:-1]
    assert torch.allclose(sums[nonempty], torch.ones(int(nonempty.sum()),
                                                     dtype=torch.float64))


def test_ids_permuted_and_communities_planted():
    g = _graph(nodes=4100, edges=120000)
    classes = small("gcn-reddit")["classes"]
    n = 4100
    block = torch.arange(n) * classes // n
    # contiguous blocks would give every label its own id range
    assert not torch.equal(g.labels.long(), block)
    assert torch.equal(torch.sort(g.labels.long()).values, block)
    assert g.stats["homophily_realized"] > 0.5


def test_too_dense_and_odd_counts_are_refused():
    with pytest.raises(ValueError):
        _graph(nodes=10, edges=99)
    with pytest.raises(ValueError):
        _graph(nodes=10, edges=80)
