"""xLSTM blocks: mLSTM (matrix memory, parallelizable) and sLSTM (scalar
memory with recurrent mixing), per arXiv:2405.04517.

mLSTM recurrence (per head):   C_t = f_t C_{t-1} + i_t v_t k_t^T
                               n_t = f_t n_{t-1} + i_t k_t
                               y_t = (C_t q_t) / max(|n_t . q_t|, 1)
— the algebra of the SSD chunked scan (decay f_t, update i_t v_t k_t^T),
so prefill uses the same chunked products; the normalizer rides along as
an extra value column (v' = [v, 1]), the state's column ``hd``.

The reference's approximations are kept: a sigmoid input gate instead of
the stabilized exponential, mLSTM at the expand-factor inner width with
fused q/k/v, sLSTM with block-diagonal recurrent mixing and no post-core
GLU (the config has d_ff = 0), and sLSTM's initial normalizer n0 = 1.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, dtype_of, rms_norm
from repro_torch.models.ssm import _decays, chunk_scan


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(gen: torch.Generator, cfg) -> dict:
    dt = dtype_of(cfg)
    d = cfg.d_model
    inner = cfg.ssm_expand * d
    H = cfg.num_heads
    return {
        "w_up": dense_init(gen, (d, 2 * inner), dt),          # [core | gate]
        "w_qkv": dense_init(gen, (inner, 3 * inner), dt),
        "w_if": dense_init(gen, (inner, 2 * H), dt),          # i, f gates
        "norm": torch.zeros((inner,), dtype=torch.float32, device=gen.device),
        "w_down": dense_init(gen, (inner, d), dt),
    }


def mlstm_block(p, x: torch.Tensor, cfg, state=None, chunk: int = 128):
    """x: [B,S,d] -> (y [B,S,d], C [B,H,hd,hd+1] float32; column hd is the
    normalizer n).  A one-token call with a ``state`` is the recurrent
    decode step; any other call runs the chunked form from ``state``."""
    B, S, d = x.shape
    inner = cfg.ssm_expand * d
    H = cfg.num_heads
    hd = inner // H

    core, gate = (x @ p.w_up).chunk(2, dim=-1)
    q, k, v = (core @ p.w_qkv).chunk(3, dim=-1)
    root = float(torch.tensor(float(hd)).sqrt())   # sqrt in float32
    q = q.reshape(B, S, H, hd).float() / root
    k = k.reshape(B, S, H, hd).float() / root
    v = v.reshape(B, S, H, hd).float()
    gates = (core @ p.w_if).float()
    i_g = torch.sigmoid(gates[..., :H])                          # [B,S,H]
    logf = F.logsigmoid(gates[..., H:])                          # [B,S,H]
    vn = torch.cat([v, v.new_ones((B, S, H, 1))], dim=-1)        # [B,S,H,hd+1]

    if S == 1 and state is not None:
        decay = torch.exp(logf[:, 0])                            # [B,H]
        upd = ((i_g[:, 0, :, None] * k[:, 0])[..., None]
               * vn[:, 0, :, None, :])                           # [B,H,hd,hd+1]
        new_state = state * decay[..., None, None] + upd
        yn = (q[:, 0, :, None, :] @ new_state)[:, None, :, 0]    # [B,1,H,hd+1]
    else:
        Q = min(chunk, S)
        if S % Q:
            raise ValueError(f"seq {S} not divisible by chunk {Q}")
        c = S // Q
        cum = torch.cumsum(logf.reshape(B, c, Q, H), dim=2)      # [B,c,Q,H]
        qc = q.reshape(B, c, Q, H, hd).transpose(2, 3)           # [B,c,H,Q,hd]
        kc = k.reshape(B, c, Q, H, hd).transpose(2, 3)
        vc = vn.reshape(B, c, Q, H, hd + 1).transpose(2, 3)      # [B,c,H,Q,hd+1]
        ic = i_g.reshape(B, c, Q, H)
        cum_h = cum.transpose(2, 3)                              # [B,c,H,Q]

        scores = qc @ kc.transpose(-1, -2)                       # [B,c,H,Q,K]
        Ldec = _decays(cum_h[..., :, None] - cum_h[..., None, :])
        tri = torch.tril(torch.ones((Q, Q), dtype=torch.float32,
                                    device=x.device))
        w = scores * Ldec * ic.transpose(2, 3)[..., None, :] * tri
        y_intra = w @ vc                                         # [B,c,H,Q,hd+1]

        rem = _decays(cum[:, :, -1:, :] - cum)                   # [B,c,Q,H]
        u = (ic * rem).transpose(2, 3)[..., None] * kc           # [B,c,H,Q,hd]
        chunk_state = u.transpose(-1, -2) @ vc                   # [B,c,H,hd,hd+1]
        chunk_decay = _decays(cum[:, :, -1, :])                  # [B,c,H]
        h0 = state if state is not None else torch.zeros(
            (B, H, hd, hd + 1), dtype=torch.float32, device=x.device)
        new_state, hprev = chunk_scan(h0, chunk_decay, chunk_state)
        y_inter = (qc @ hprev) * _decays(cum_h)[..., None]       # [B,c,H,Q,hd+1]
        yn = (y_intra + y_inter).transpose(2, 3).reshape(B, S, H, hd + 1)

    y, nq = yn[..., :hd], yn[..., hd:]
    y = y / torch.clamp(nq.abs(), min=1.0)
    y = y.reshape(B, S, inner).to(x.dtype) * F.silu(gate)
    y = rms_norm(y, p.norm, cfg.norm_eps)
    return y @ p.w_down, new_state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(gen: torch.Generator, cfg) -> dict:
    dt = dtype_of(cfg)
    d = cfg.d_model
    H = cfg.num_heads
    hd = d // H
    return {
        "w_in": dense_init(gen, (d, 4 * d), dt),              # z, i, f, o
        "r": dense_init(gen, (H, 4, hd, hd), dt,
                        scale=1.0 / math.sqrt(hd)),           # block-diag R
        "norm": torch.zeros((d,), dtype=torch.float32, device=gen.device),
        "w_out": dense_init(gen, (d, d), dt),
    }


def slstm_block(p, x: torch.Tensor, cfg, state=None):
    """A sequential loop over S (h_{t-1} feeds the gates through the
    block-diagonal recurrent matrices).  state = (c, n, h): [B, d] float32
    each, or None for (0, 1, 0).  Returns (y [B,S,d], (c, n, h))."""
    B, S, d = x.shape
    H = cfg.num_heads
    hd = d // H

    pre = (x @ p.w_in).float()                                   # [B,S,4d]
    r = p.r.float()
    if state is None:
        c = x.new_zeros((B, d), dtype=torch.float32)
        n = x.new_ones((B, d), dtype=torch.float32)
        h = x.new_zeros((B, d), dtype=torch.float32)
    else:
        c, n, h = state

    hs = []
    for t in range(S):
        rec = torch.einsum("bhd,hgde->bhge", h.reshape(B, H, hd), r
                           ).reshape(B, 4, d)
        zi = pre[:, t].reshape(B, 4, d) + rec
        z = torch.tanh(zi[:, 0])
        i = torch.sigmoid(zi[:, 1])
        f = torch.sigmoid(zi[:, 2])
        o = torch.sigmoid(zi[:, 3])
        c = f * c + i * z
        n = f * n + i
        h = o * c / torch.clamp(n, min=1.0)
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)                       # [B,S,d]
    y = rms_norm(y, p.norm, cfg.norm_eps)
    return y @ p.w_out, (c, n, h)
