"""AdamW with decoupled weight decay and global-norm clipping, over a dict
of tensors (parameter name -> tensor).

The reference package's optimizer step for step, not ``torch.optim.AdamW``:
b2 defaults to 0.95; gradients are clipped to a global norm of 1.0 with
the scale ``min(1, max_norm / max(norm, 1e-12))``; weight decay is added
to the update before its product with ``lr``; the step count is int32 and
the bias corrections ``1 - b**t`` are taken in float32.  The functions are
pure: they return new tensors and leave their arguments as they are.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: dict            # first moment, same keys as the parameters
    nu: dict            # second moment


def adamw_init(params: dict) -> AdamWState:
    """Zero moments (float32) and step 0, on the parameters' devices."""
    mu = {k: torch.zeros_like(p, dtype=torch.float32)
          for k, p in params.items()}
    nu = {k: m.clone() for k, m in mu.items()}
    device = next(iter(params.values())).device if params else None
    return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                      mu, nu)


def global_norm(tensors: dict) -> torch.Tensor:
    """The float32 2-norm of all the tensors together, summed in key
    order."""
    total = sum(torch.sum(torch.square(t.to(torch.float32)))
                for t in tensors.values())
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads: dict, max_norm: float):
    """``grads`` scaled so their global norm is at most ``max_norm``, and
    the norm before the scaling."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


def adamw_update(grads: dict, state: AdamWState, params: dict, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 max_grad_norm: float | None = 1.0):
    """One AdamW step: ``(new_params, new_state)``.  ``lr`` may be a
    scalar or a schedule value; ``max_grad_norm=None`` turns clipping
    off."""
    if max_grad_norm is not None:
        grads, _ = clip_by_global_norm(grads, max_grad_norm)
    step = state.step + 1
    t = step.to(torch.float32)
    c1 = 1.0 - b1**t
    c2 = 1.0 - b2**t
    mu, nu, new_params = {}, {}, {}
    for k, g in grads.items():
        p = params[k]
        g32 = g.to(torch.float32)
        m = b1 * state.mu[k] + (1 - b1) * g32
        v = b2 * state.nu[k] + (1 - b2) * torch.square(g32)
        update = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay:
            update = update + weight_decay * p.to(torch.float32)
        mu[k], nu[k] = m, v
        new_params[k] = (p.to(torch.float32) - lr * update).to(p.dtype)
    return new_params, AdamWState(step, mu, nu)
