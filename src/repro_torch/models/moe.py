"""Mixture-of-experts layer: top-k routing, sort-based grouped products,
optional shared experts (DeepSeek-V2).  The router runs in float32.

The reference's ``jax.lax.ragged_dot`` becomes one ``torch.matmul`` per
expert over its contiguous slice of the expert-sorted rows; the slice
sizes are read on the host once a layer call.  Expert counts are a
comparison and a sum (:func:`expert_counts`), where the reference uses a
scatter-add and ``torch.bincount`` has no DTensor strategy.
"""
from __future__ import annotations

import math

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor

from repro_torch.models.layers import (activation, contiguous_grads,
                                       dense_init, dtype_of, init_mlp, mlp)


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


def expert_counts(e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """How many entries of ``e`` name each expert ([E] int64): the counts
    ``torch.bincount(e, minlength=E)`` gives, as a comparison and a sum,
    which have DTensor strategies and a fixed output shape."""
    return (e[:, None] == torch.arange(num_experts, device=e.device)).sum(0)


def _group_sizes(flat_e: torch.Tensor, num_experts: int) -> list[int]:
    """Rows an expert, read on the host.  A fake tensor (the dry run) has
    no values: it takes an even split, whose product flops equal any
    routing's (they depend only on the T*K rows in all)."""
    if is_fake(flat_e):
        base, extra = divmod(flat_e.shape[0], num_experts)
        return [base + (e < extra) for e in range(num_experts)]
    return expert_counts(flat_e, num_experts).tolist()


def _route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """Top-k routing of the tokens of ``x`` [B, S, d] (router in float32).
    Returns (probabilities [T, E], renormalized top-k weights [T, K],
    their experts [T, K])."""
    xt = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(xt.float() @ router, dim=-1)           # [T, E]
    # jax.lax.top_k: the lower expert id first on ties, as a stable sort
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :top_k], top_e[:, :top_k]            # [T, K]
    return probs, top_p / torch.clamp(top_p.sum(-1, keepdim=True),
                                      min=1e-9), top_e


def _dispatch(x, top_p, top_e, w_gate, w_up, w_down, e0: int,
              num_experts: int, act: str):
    """The routed experts ``e0 .. e0 + len(w_gate)`` on the tokens of
    ``x`` [B, S, d]: the (token, k) pairs sorted by expert, one product
    an expert over its slice of rows, then a weighted scatter-add back to
    the tokens.  Returns their sum [B, S, d]."""
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    flat_e = top_e.reshape(-1)                                   # [T*K]
    flat_t = torch.arange(T, device=x.device).repeat_interleave(
        top_e.shape[1])
    order = torch.argsort(flat_e, stable=True)
    sizes = _group_sizes(flat_e, num_experts)
    lo = sum(sizes[:e0])
    sizes = sizes[e0:e0 + w_gate.shape[0]]
    pairs = order[lo:lo + sum(sizes)]
    rows = flat_t[pairs]
    xs = xt[rows]                                                # [rows, d]
    outs = []
    for e, xe in enumerate(torch.split(xs, sizes)):
        if sizes[e]:
            hidden = activation(xe @ w_gate[e], act) * (xe @ w_up[e])
            outs.append(hidden @ w_down[e])
    out = torch.cat(outs) if outs else xs.new_zeros((0, d))

    # combine: weighted scatter-add back to the tokens, in sorted order
    out = out * top_p.reshape(-1)[pairs][:, None].to(out.dtype)
    return torch.zeros((T, d), dtype=out.dtype, device=x.device).index_add_(
        0, rows, out).reshape(B, S, d)


def _token_placements(x) -> list:
    """Placements of ``x`` [B, S, d] and of per-token tensors [T, ...]:
    batch (tokens) over the DP axes where it divides, else replicated."""
    from repro_torch.distributed.sharding import batch_shardings, to_placements

    return to_placements(batch_shardings(x.device_mesh, {"x": x})["x"],
                         x.device_mesh)


def _sharded_route(p, x, top_k: int):
    """:func:`_route` on DTensors, each rank routing its own tokens
    (``local_map``), the router replicated and its gradient pending over
    the DP axes: op by op, DTensor would split the tokens over the idle
    ``model`` axis too, which a batch of 256 on 512 ranks cannot take
    back."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    x_pl = _token_placements(x)
    r_pl = list(p.router.placements)
    r_grad = [Partial() if t.is_shard() else r for t, r in zip(x_pl, r_pl)]
    fn = local_map(contiguous_grads(_route),
                   out_placements=(x_pl, x_pl, x_pl),
                   in_placements=(x_pl, r_pl, None),
                   in_grad_placements=(x_pl, r_grad, None),
                   device_mesh=x.device_mesh, redistribute_inputs=True)
    return fn(x, p.router, top_k)


def _sharded_dispatch(p, x, top_p, top_e, num_experts: int, act: str):
    """:func:`_dispatch` on DTensors, one call a rank on its local blocks
    (``local_map``): each rank sends its own tokens (batch over the DP
    axes, replicated over ``model``) to the experts it holds -- a slice
    of them where the rules shard experts over ``model`` (EP), or every
    expert at a slice of its hidden width.  The sum is then pending over
    ``model`` (``Partial``), and so are the gradients of ``x`` and of
    the routing weights; the experts' gradients are pending over the DP
    axes that shard the tokens."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.distributed.sharding import axis_names

    mesh = x.device_mesh
    names = axis_names(mesh)
    x_pl = _token_placements(x)
    held = [pl.is_shard() for pl in p.w_gate.placements]
    e0 = 0
    if "model" in names and p.w_gate.placements[names.index("model")] \
            .is_shard(0):
        e0 = (mesh.get_coordinate()[names.index("model")]
              * p.w_gate.to_local().shape[0])
    out_pl = [Partial() if held[i] else x_pl[i] for i in range(len(names))]

    def weight_grads(w):
        return [Partial() if x_pl[i].is_shard() else pl
                for i, pl in enumerate(w.placements)]

    ws = (p.w_gate, p.w_up, p.w_down)
    fn = local_map(
        contiguous_grads(_dispatch), out_placements=out_pl,
        in_placements=(x_pl, x_pl, x_pl, *(w.placements for w in ws),
                       None, None, None),
        in_grad_placements=(out_pl, out_pl, x_pl,
                            *(weight_grads(w) for w in ws), None, None,
                            None),
        device_mesh=mesh, redistribute_inputs=True)
    return fn(x, top_p, top_e, *ws, e0, num_experts, act)


def moe_mlp(p, x: torch.Tensor, cfg, act: str = "silu"):
    """x: [B, S, d] -> ([B, S, d], aux_loss).  Dropless sort-based
    dispatch; on DTensors, each rank dispatches its own tokens to the
    experts it holds (:func:`_sharded_dispatch`)."""
    m = cfg.moe
    B, S, _ = x.shape
    T = B * S
    sharded = isinstance(x, DTensor)
    probs, top_p, top_e = (_sharded_route(p, x, m.top_k) if sharded
                           else _route(x, p.router, m.top_k))

    # Switch-style load-balance auxiliary
    frac_tokens = expert_counts(top_e[:, 0], m.num_experts).float() / T
    aux = m.num_experts * torch.sum(frac_tokens * probs.mean(dim=0))

    if sharded:
        combined = _sharded_dispatch(p, x, top_p, top_e, m.num_experts, act)
    else:
        combined = _dispatch(x, top_p, top_e, p.w_gate, p.w_up, p.w_down, 0,
                             m.num_experts, act)
    if m.num_shared_experts:
        combined = combined + mlp(p.shared, x, act)
    return combined, aux
