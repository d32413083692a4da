"""Plain reference of the 2-layer GraphSAGE with the mean aggregator
(Hamilton et al. 2017) as the benchmark runs it:
``h = relu(X Ws1 + (A' X) Wn1 + b1)``, logits ``h Ws2 + (A' h) Wn2 + b2``
with ``A' = D^-1 A``, each ``A' H`` the AES-sampled product."""
from __future__ import annotations

import torch

#: The adjacency the model reads: ``A``, row-mean normalization.
SELF_LOOPS = False
NORM = "mean"


def shapes(cfg: dict) -> dict:
    """Parameter shapes, in the order the program's ``GraphSAGE`` takes
    them."""
    f, h, c = cfg["features"], cfg["hidden"], cfg["classes"]
    return {"w_self1": (f, h), "w_neigh1": (f, h), "b1": (h,),
            "w_self2": (h, c), "w_neigh2": (h, c), "b2": (c,)}


def aggregations(cfg: dict) -> list:
    """The operand width of each aggregation of one forward pass."""
    return [cfg["features"], cfg["hidden"]]


def gemms(cfg: dict) -> list:
    """``(in, out)`` of each dense transform of one forward pass."""
    f, h, c = cfg["features"], cfg["hidden"], cfg["classes"]
    return [(f, h), (f, h), (h, c), (h, c)]


def forward(agg, mm, x, p):
    h = torch.relu(mm(x, p["w_self1"]) + mm(agg(x), p["w_neigh1"]) + p["b1"])
    return mm(h, p["w_self2"]) + mm(agg(h), p["w_neigh2"]) + p["b2"]
