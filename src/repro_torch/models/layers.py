"""Shared LM building blocks: the parameter container, RMSNorm, RoPE, init
helpers and the gated MLP.

Parameters keep the reference package's leaf names and shapes
(``params["attn"]["wq"]`` there is ``module.attn.wq`` here).  Dtype rules
follow the reference's results: where it mixes bfloat16 and float32 the
product runs in float32 (JAX promotes, ``torch`` refuses), see
:func:`einsum`.
"""
from __future__ import annotations

import math
from collections.abc import Mapping

import torch
import torch.nn.functional as F
from torch import nn


class ParamTree(nn.Module):
    """Nested parameters from a tree of tensors: a mapping becomes a
    submodule, a list of mappings a ``ModuleList``, a list of tensors a
    ``ParameterList``, a tensor a parameter that takes no gradient
    (training substitutes its own tensors through
    ``torch.func.functional_call``)."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, value in tree.items():
            if isinstance(value, Mapping):
                self.add_module(name, ParamTree(value))
            elif isinstance(value, (list, tuple)) and value and all(
                    isinstance(v, torch.Tensor) for v in value):
                self.add_module(name, nn.ParameterList(
                    nn.Parameter(v, requires_grad=False) for v in value))
            elif isinstance(value, (list, tuple)):
                self.add_module(name, nn.ModuleList(ParamTree(v)
                                                    for v in value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))


def dtype_of(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.param_dtype == "bfloat16" else torch.float32


def dense_init(gen: torch.Generator, shape, dtype, scale: float | None = None
               ) -> torch.Tensor:
    """Normal draw in float32 on ``gen``'s device, times ``scale`` (default
    ``1/sqrt(shape[0])``), cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[0])
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=gen.device) * scale).to(dtype)


def zeros(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor,
           dtype: torch.dtype | None = None) -> torch.Tensor:
    """``torch.einsum`` on operands cast to ``dtype``, by default their
    promoted type: JAX's result type for mixed bfloat16/float32 operands.
    ``dtype=torch.float32`` is the reference's
    ``preferred_element_type=jnp.float32``: the operands are upcast before
    the product, so nothing is rounded to bfloat16 on the way."""
    dt = dtype or torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(eq, a.to(dt), b.to(dt))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with the ``1 + gamma`` scale, in float32 inside."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq].  Rotates the
    two halves of the head dimension (not interleaved pairs)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs
    cos = torch.cos(angles)[..., None, :]          # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def init_mlp(gen: torch.Generator, cfg, d_ff: int | None = None) -> dict:
    d_ff = d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    return {"w_gate": dense_init(gen, (cfg.d_model, d_ff), dt),
            "w_up": dense_init(gen, (cfg.d_model, d_ff), dt),
            "w_down": dense_init(gen, (d_ff, cfg.d_model), dt)}


def activation(a: torch.Tensor, act: str) -> torch.Tensor:
    """SiLU, or GELU in ``jax.nn.gelu``'s default tanh form."""
    return F.silu(a) if act == "silu" else F.gelu(a, approximate="tanh")


def mlp(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """Gated MLP: SwiGLU (silu) or GeGLU (gelu)."""
    return (activation(x @ p.w_gate, act) * (x @ p.w_up)) @ p.w_down
