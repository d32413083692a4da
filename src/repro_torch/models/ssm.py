"""Mamba2-style selective state-space block (chunked SSD formulation).

Prefill: the SSD algorithm — within-chunk terms as attention-like
products over a chunk's positions, across-chunk recurrence as a Python
loop over the chunk-boundary states.  Decode: the O(1) recurrent update.

Recurrence per head h, channel p, state n (B/C shared across heads as in
Mamba2):   H_t = exp(dt_t A_h) H_{t-1} + dt_t B_t x_t ;  y_t = C_t . H_t

Weights keep the reference's head-major layout ([d, H, hd] / [H, hd, d]).
The reference's three- and four-operand einsums are written as explicit
broadcasts and one batched product each: contracted left to right they
could build a [B, c, Q, H, hd, n] intermediate (15 GB at Zamba2's width).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.attention import _project_heads, _project_out
from repro_torch.models.layers import dense_init, dtype_of


def init_mamba(gen: torch.Generator, cfg) -> dict:
    dt = dtype_of(cfg)
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    n = cfg.ssm_state
    H = cfg.num_heads
    hd = inner // H
    sc = 1.0 / math.sqrt(d)
    f32 = dict(dtype=torch.float32, device=gen.device)
    return {
        "w_z": dense_init(gen, (d, H, hd), dt, scale=sc),    # gate
        "w_x": dense_init(gen, (d, H, hd), dt, scale=sc),
        "w_B": dense_init(gen, (d, n), dt, scale=sc),
        "w_C": dense_init(gen, (d, n), dt, scale=sc),
        "w_dt": dense_init(gen, (d, H), dt, scale=sc),
        "conv_x": dense_init(gen, (cfg.ssm_conv, H, hd), dt, scale=0.1),
        "conv_B": torch.zeros((cfg.ssm_conv, n), dtype=dt, device=gen.device),
        "conv_C": torch.zeros((cfg.ssm_conv, n), dtype=dt, device=gen.device),
        "A_log": torch.zeros((H,), **f32),
        "D": torch.ones((H,), **f32),
        "dt_bias": torch.zeros((H,), **f32),
        "norm": torch.zeros((H, hd), **f32),
        "w_out": dense_init(gen, (H, hd, d), dt, scale=1.0 / math.sqrt(inner)),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, cache=None):
    """Depthwise causal conv1d over axis 1.  u: [B,S,...ch]; w: [K,...ch];
    cache: [B, K-1, ...ch] trailing context (decode) or None (zeros).
    Returns (silu(conv), the new trailing context [B, K-1, ...ch])."""
    K = w.shape[0]
    S = u.shape[1]
    if cache is not None:
        full = torch.cat([cache.to(u.dtype), u], dim=1)
    else:
        full = torch.cat([u.new_zeros((u.shape[0], K - 1, *u.shape[2:])), u],
                         dim=1)
    new_cache = full[:, full.shape[1] - (K - 1):]
    out = sum(full[:, i:i + S] * w[i] for i in range(K))
    return F.silu(out), new_cache


def _decays(cum: torch.Tensor) -> torch.Tensor:
    """exp(clip(cum, -60, 0)), the reference's guarded decay."""
    return torch.exp(torch.clamp(cum, -60.0, 0.0))


def chunk_scan(h0: torch.Tensor, chunk_decay: torch.Tensor,
               chunk_state: torch.Tensor):
    """The across-chunk recurrence h <- h * decay + state, a Python loop
    over the chunk axis 1.  h0 [B,H,a,b]; chunk_decay [B,c,H];
    chunk_state [B,c,H,a,b].  Returns (final state, the state entering
    each chunk [B,c,H,a,b])."""
    h, before = h0, []
    for j in range(chunk_decay.shape[1]):
        before.append(h)
        h = h * chunk_decay[:, j, :, None, None] + chunk_state[:, j]
    return h, torch.stack(before, dim=1)


def mamba_block(p, x: torch.Tensor, cfg, state=None, conv_cache=None,
                chunk: int = 128):
    """x: [B, S, d] -> (y [B, S, d], final_state [B,H,hd,n] float32,
    conv caches {x, B, C}).

    ``conv_cache``: dict of {x, B, C} trailing contexts (decode) or None.
    A one-token call with a ``state`` is the recurrent decode step; any
    other call runs the chunked scan from ``state`` (zeros when None).
    """
    B, S, d = x.shape
    inner = cfg.ssm_expand * d
    n = cfg.ssm_state
    H = cfg.num_heads
    hd = inner // H

    z = _project_heads(x, p.w_z)
    xr = _project_heads(x, p.w_x)
    Br = x @ p.w_B
    Cr = x @ p.w_C
    dt_raw = x @ p.w_dt

    cc = conv_cache or {}
    xr, cx = _causal_conv(xr, p.conv_x, cc.get("x"))
    Br, cB = _causal_conv(Br, p.conv_B, cc.get("B"))
    Cr, cC = _causal_conv(Cr, p.conv_C, cc.get("C"))
    new_conv = {"x": cx, "B": cB, "C": cC}

    dt = F.softplus(dt_raw.float() + p.dt_bias)                   # [B,S,H]
    A = -torch.exp(p.A_log)                                       # [H]
    xh = xr.float()                                               # [B,S,H,hd]
    Bf = Br.float()
    Cf = Cr.float()

    if S == 1 and state is not None:
        decay = torch.exp(dt[:, 0] * A)                           # [B,H]
        upd = ((dt[:, 0, :, None] * xh[:, 0])[..., None]
               * Bf[:, 0, None, None, :])                         # [B,H,hd,n]
        final_state = state * decay[..., None, None] + upd
        y = (final_state @ Cf[:, 0, None, :, None])[..., 0][:, None]
    else:
        Q = min(chunk, S)
        if S % Q:
            raise ValueError(f"seq {S} not divisible by chunk {Q}")
        c = S // Q
        cum = torch.cumsum((dt * A).reshape(B, c, Q, H), dim=2)   # [B,c,Q,H]
        xc = xh.reshape(B, c, Q, H, hd).transpose(2, 3)           # [B,c,H,Q,hd]
        Bc = Bf.reshape(B, c, Q, n)
        Cc = Cf.reshape(B, c, Q, n)
        dtc = dt.reshape(B, c, Q, H)
        cum_h = cum.transpose(2, 3)                               # [B,c,H,Q]

        # intra-chunk: y_t += sum_{s<=t} (C_t.B_s) exp(cum_t - cum_s) dt_s x_s
        scores = Cc @ Bc.transpose(-1, -2)                        # [B,c,Q,K]
        Ldec = _decays(cum_h[..., :, None] - cum_h[..., None, :])  # [B,c,H,Q,K]
        tri = torch.tril(torch.ones((Q, Q), dtype=torch.float32,
                                    device=x.device))
        w = (scores[:, :, None] * Ldec * dtc.transpose(2, 3)[..., None, :]
             * tri)                                               # [B,c,H,Q,K]
        y_intra = w @ xc                                          # [B,c,H,Q,hd]

        # chunk-boundary states, then the across-chunk scan
        rem = _decays(cum[:, :, -1:, :] - cum)                    # [B,c,Q,H]
        u = (rem * dtc)[..., None] * xh.reshape(B, c, Q, H, hd)
        chunk_state = (u.flatten(3).transpose(-1, -2) @ Bc
                       ).unflatten(2, (H, hd))                    # [B,c,H,hd,n]
        chunk_decay = _decays(cum[:, :, -1, :])                   # [B,c,H]
        h0 = state if state is not None else torch.zeros(
            (B, H, hd, n), dtype=torch.float32, device=x.device)
        final_state, hprev = chunk_scan(h0, chunk_decay, chunk_state)
        y_inter = ((Cc[:, :, None] @ hprev.transpose(-1, -2))
                   * _decays(cum_h)[..., None])                   # [B,c,H,Q,hd]
        y = (y_intra + y_inter).transpose(2, 3).reshape(B, S, H, hd)

    y = y + p.D[None, None, :, None] * xh.reshape(B, S, H, hd)
    y = y.to(x.dtype) * F.silu(z)
    y32 = y.float()
    var = y32.square().mean(-1, keepdim=True)
    y = (y32 * torch.rsqrt(var + cfg.norm_eps) * (1.0 + p.norm)).to(x.dtype)
    return _project_out(y, p.w_out), final_state, new_conv
