"""Mixture-of-experts layer: top-k routing, sort-based grouped products,
optional shared experts (DeepSeek-V2).  The router runs in float32.

The reference's ``jax.lax.ragged_dot`` becomes one ``torch.matmul`` per
expert over its contiguous slice of the expert-sorted rows; the slice
sizes are read on the host once a layer call.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.layers import (activation, dense_init, dtype_of,
                                       init_mlp, mlp)


def init_moe(gen: torch.Generator, cfg) -> dict:
    m = cfg.moe
    dt = dtype_of(cfg)
    E, d, f = m.num_experts, cfg.d_model, m.d_ff_expert

    def experts(shape):
        return dense_init(gen, shape, dt, scale=1.0 / math.sqrt(shape[1]))

    p = {"router": dense_init(gen, (d, E), torch.float32),
         "w_gate": experts((E, d, f)),
         "w_up": experts((E, d, f)),
         "w_down": experts((E, f, d))}
    if m.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d_ff=f * m.num_shared_experts)
    return p


def moe_mlp(p, x: torch.Tensor, cfg, act: str = "silu"):
    """x: [B, S, d] -> ([B, S, d], aux_loss).  Dropless sort-based
    dispatch."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)

    probs = torch.softmax(xt.float() @ p.router, dim=-1)         # [T, E]
    # jax.lax.top_k: the lower expert id first on ties, as a stable sort
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :m.top_k], top_e[:, :m.top_k]        # [T, K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance auxiliary
    frac_tokens = torch.bincount(top_e[:, 0], minlength=m.num_experts
                                 ).float() / T
    aux = m.num_experts * torch.sum(frac_tokens * probs.mean(dim=0))

    # (token, k) pairs sorted by expert id -> one slice of rows an expert
    flat_e = top_e.reshape(-1)                                   # [T*K]
    flat_t = torch.arange(T, device=x.device).repeat_interleave(m.top_k)
    order = torch.argsort(flat_e, stable=True)
    rows = flat_t[order]
    xs = xt[rows]                                                # [T*K, d]
    sizes = torch.bincount(flat_e, minlength=m.num_experts).tolist()
    outs = []
    for e, xe in enumerate(torch.split(xs, sizes)):
        if sizes[e]:
            hidden = activation(xe @ p.w_gate[e], act) * (xe @ p.w_up[e])
            outs.append(hidden @ p.w_down[e])
    out = torch.cat(outs)

    # combine: weighted scatter-add back to the tokens, in sorted order
    out = out * top_p.reshape(-1)[order][:, None].to(out.dtype)
    combined = torch.zeros((T, d), dtype=out.dtype,
                           device=x.device).index_add_(0, rows, out)
    if m.num_shared_experts:
        combined = combined + mlp(p.shared, xt, act)
    return combined.reshape(B, S, d), aux
