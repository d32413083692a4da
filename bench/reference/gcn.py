"""Plain reference of the 2-layer GCN (Kipf & Welling 2017) as the
benchmark runs it: ``A' relu(A' X W1 + b1) W2 + b2`` with
``A' = D^-1/2 (A + I) D^-1/2``, each ``A' H`` the AES-sampled product."""
from __future__ import annotations

import torch

#: The adjacency the model reads: ``A + I``, symmetric normalization.
SELF_LOOPS = True
NORM = "sym"


def shapes(cfg: dict) -> dict:
    """Parameter shapes, in the order the program's ``GCN`` takes them."""
    f, h, c = cfg["features"], cfg["hidden"], cfg["classes"]
    return {"w1": (f, h), "b1": (h,), "w2": (h, c), "b2": (c,)}


def aggregations(cfg: dict) -> list:
    """The operand width of each aggregation of one forward pass."""
    return [cfg["features"], cfg["hidden"]]


def gemms(cfg: dict) -> list:
    """``(in, out)`` of each dense transform of one forward pass."""
    f, h, c = cfg["features"], cfg["hidden"], cfg["classes"]
    return [(f, h), (h, c)]


def forward(agg, mm, x, p):
    h = torch.relu(mm(agg(x), p["w1"]) + p["b1"])
    return mm(agg(h), p["w2"]) + p["b2"]
