"""Attention variants: GQA/MQA/MHA with RoPE and an optional sliding
window, DeepSeek-V2 MLA (latent KV cache, absorbed decode products), and
AES-KV, the paper's adaptive edge sampling applied to KV positions (the
Table 1 strategy and the Eq. 3 hash on the cache as one CSR row).

Shapes: activations [B, S, d_model]; KV cache [B, S_max, KV, head_dim].
Decode writes the new position into the cache in place, at a Python-int
``cache_len`` (a device scalar as an index would make the host wait).
Result types are the reference's: scores in float32 from operands upcast
before the product, softmax weights cast to the value dtype.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.core.sampling import PRIME_NUM
from repro_torch.models.layers import (apply_rope, dense_init, dtype_of,
                                       einsum, rms_norm, zeros)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# AES-KV
# ---------------------------------------------------------------------------

def aes_kv_indices(seq_len: int, width: int) -> np.ndarray:
    """Sample ``width`` KV positions from a cache of ``seq_len`` with the
    paper's strategy table and hash, the KV sequence taken as one CSR row
    of ``seq_len`` entries; the last ``sample_cnt`` slots are pinned to the
    most recent positions."""
    nnz = seq_len
    W = min(nnz, width)
    R = nnz / W
    if R <= 1:
        N, cnt = nnz, 1
    elif R <= 2:
        N, cnt = W // 4, 4
    elif R <= 36:
        N, cnt = W // 8, 8
    elif R <= 54:
        N, cnt = W // 16, 16
    else:
        N, cnt = W // 32, 32
    N = max(N, 1)
    cnt = min(cnt, max(W, 1))
    idx = np.zeros(width, np.int64)
    for i in range(cnt):
        start = (i * PRIME_NUM) % (nnz - N + 1)
        for j in range(N):
            slot = i + j * cnt
            if slot >= width:
                break
            idx[slot] = start + j
    # dead slots point at position 0; the tail slots keep the most recent
    # positions reachable (local context dominates LM attention)
    tail = min(cnt, width)
    idx[width - tail:] = np.arange(nnz - tail, nnz)
    return idx


@functools.lru_cache(maxsize=64)
def aes_kv_index(seq_len: int, width: int, device: torch.device
                 ) -> torch.Tensor:
    """:func:`aes_kv_indices` as a tensor on ``device``, made once a
    ``(seq_len, width, device)``: every layer of every decode step reuses
    it instead of copying it from the host."""
    return torch.from_numpy(aes_kv_indices(seq_len, width)).to(device)


def _sampled_positions(cfg, S_max: int, device):
    """The cache positions a decode step reads: all ``S_max``, or AES-KV's
    ``cfg.aes_kv_width`` of them when that is narrower than the cache."""
    if cfg.aes_kv_width is not None and cfg.aes_kv_width < S_max:
        return aes_kv_index(S_max, cfg.aes_kv_width, device)
    return None


# ---------------------------------------------------------------------------
# GQA / MQA / MHA
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg) -> dict:
    """Weights kept 3-D ([d_model, heads, head_dim]), as in the reference."""
    dt = dtype_of(cfg)
    hd = cfg.resolved_head_dim
    d, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    p = {"wq": dense_init(gen, (d, H, hd), dt, scale=1.0 / math.sqrt(d)),
         "wk": dense_init(gen, (d, KV, hd), dt, scale=1.0 / math.sqrt(d)),
         "wv": dense_init(gen, (d, KV, hd), dt, scale=1.0 / math.sqrt(d)),
         "wo": dense_init(gen, (H, hd, d), dt,
                          scale=1.0 / math.sqrt(H * hd))}
    if cfg.attn_bias:
        p["bq"] = zeros(gen, (H, hd), dt)
        p["bk"] = zeros(gen, (KV, hd), dt)
        p["bv"] = zeros(gen, (KV, hd), dt)
    return p


def _project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", x, w)`` as one matrix product."""
    return (x @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _project_out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", out, wo)`` in the promoted dtype."""
    dt = torch.promote_types(out.dtype, wo.dtype)
    return out.flatten(2).to(dt) @ wo.flatten(0, 1).to(dt)


def _qkv(p, x, cfg, positions):
    q = _project_heads(x, p.wq)
    k = _project_heads(x, p.wk)
    v = _project_heads(x, p.wv)
    if cfg.attn_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(q, k, v, mask):
    """Grouped attention core.  q [B,Sq,H,D]; k,v [B,Sk,KV,D];
    mask [B|1,Sq,Sk] bool (True = attend).  Returns [B,Sq,KV,G,D]."""
    B, Sq, H, D = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, D)
    scores = einsum("bqngd,bknd->bngqk", qg, k, torch.float32)
    scores = scores / math.sqrt(D)
    scores = scores.masked_fill(~mask[:, None, None], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bngqk,bknd->bqngd", w, v)


def causal_mask(Sq: int, Sk: int, q_offset: int, window: int | None = None,
                device=None) -> torch.Tensor:
    """[1, Sq, Sk] True where query may attend key."""
    qpos = q_offset + torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    m = kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m[None]


def attention(p, x, cfg, positions, *, window=None):
    """Full-sequence causal attention (prefill).  Returns
    (out [B,S,d_model], (k, v) for the cache)."""
    q, k, v = _qkv(p, x, cfg, positions)
    S = x.shape[1]
    mask = causal_mask(S, S, 0, window=window, device=x.device)
    out = _attend(q, k, v, mask)
    return _project_out(out.flatten(2, 3), p.wo), (k, v)


def quantize_kv(t: torch.Tensor, bits: int = 8):
    """Paper Eq. 1 on KV rows [..., KV, D]: a symmetric scale per head,
    int8 storage.  Returns (q int8, scale float32 [..., KV])."""
    levels = 2 ** (bits - 1) - 1
    t32 = t.float()
    scale = torch.clamp(t32.abs().amax(dim=-1) / levels, min=1e-8)
    q = torch.clamp(torch.round(t32 / scale[..., None]), -levels,
                    levels).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Paper Eq. 2: back to ``dtype`` at the attention read."""
    return (q.float() * scale[..., None]).to(dtype)


def attention_decode(p, x, cache_k, cache_v, cache_len: int, cfg, *,
                     window=None, cache_ks=None, cache_vs=None):
    """One-token decode: x [B,1,d_model]; cache_[kv] [B,S_max,KV,D].

    Writes the new K/V at ``cache_len`` into the cache tensors (and their
    scales, for the int8 cache) in place and returns the attention output
    [B,1,d_model].  With a sliding window and a window-sized buffer
    (S_max <= window) the cache is a ring: writes wrap modulo S_max and
    every warm slot is valid (keys keep the RoPE of their true positions).
    Samples the positions read with AES-KV when ``cfg.aes_kv_width`` is
    set and narrower than the cache."""
    B = x.shape[0]
    S_max = cache_k.shape[1]
    ring = window is not None and S_max <= window
    write_pos = cache_len % S_max if ring else cache_len
    positions = torch.full((B, 1), cache_len, device=x.device)
    q, k_new, v_new = _qkv(p, x, cfg, positions)
    quant = cache_ks is not None
    if quant:
        bits = cfg.kv_quant_bits or 8
        kq, ks = quantize_kv(k_new, bits)
        vq, vs = quantize_kv(v_new, bits)
        cache_k[:, write_pos] = kq[:, 0]
        cache_v[:, write_pos] = vq[:, 0]
        cache_ks[:, write_pos] = ks[:, 0]
        cache_vs[:, write_pos] = vs[:, 0]
    else:
        cache_k[:, write_pos] = k_new[:, 0]       # cast as the reference's
        cache_v[:, write_pos] = v_new[:, 0]       # astype(cache dtype)

    k, v, ks_r, vs_r = cache_k, cache_v, cache_ks, cache_vs
    idx = _sampled_positions(cfg, S_max, x.device)
    if idx is not None:
        k, v = cache_k[:, idx], cache_v[:, idx]
        if quant:
            ks_r, vs_r = cache_ks[:, idx], cache_vs[:, idx]
        kpos = idx[None, :]
    else:
        kpos = torch.arange(S_max, device=x.device)[None, :]
    if quant:
        k = dequantize_kv(k, ks_r)
        v = dequantize_kv(v, vs_r)
    if ring:
        valid = (kpos <= write_pos if cache_len < S_max
                 else torch.ones_like(kpos, dtype=torch.bool))
    else:
        valid = kpos <= cache_len
        if window is not None:
            valid &= kpos > cache_len - window
    out = _attend(q, k, v, valid[:, None, :])
    return _project_out(out.flatten(2, 3), p.wo)


# ---------------------------------------------------------------------------
# DeepSeek-V2 MLA
# ---------------------------------------------------------------------------

def init_mla(gen: torch.Generator, cfg) -> dict:
    m = cfg.mla
    dt = dtype_of(cfg)
    H, d = cfg.num_heads, cfg.d_model
    return {
        "w_dq": dense_init(gen, (d, m.q_lora_rank), dt),
        "q_norm": zeros(gen, (m.q_lora_rank,), torch.float32),
        "w_uq": dense_init(gen, (m.q_lora_rank, H,
                                 m.nope_head_dim + m.rope_head_dim), dt,
                           scale=1.0 / math.sqrt(m.q_lora_rank)),
        "w_dkv": dense_init(gen, (d, m.kv_lora_rank + m.rope_head_dim), dt),
        "kv_norm": zeros(gen, (m.kv_lora_rank,), torch.float32),
        "w_uk": dense_init(gen, (m.kv_lora_rank, H, m.nope_head_dim), dt),
        "w_uv": dense_init(gen, (m.kv_lora_rank, H, m.v_head_dim), dt),
        "wo": dense_init(gen, (H, m.v_head_dim, d), dt,
                         scale=1.0 / math.sqrt(H * m.v_head_dim)),
    }


def _mla_q(p, x, cfg, positions):
    m = cfg.mla
    cq = rms_norm(x @ p.w_dq, p.q_norm, cfg.norm_eps)
    q = _project_heads(cq, p.w_uq)
    q_nope, q_pe = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_pe, positions, cfg.rope_theta)


def _mla_latent(p, x, cfg, positions):
    m = cfg.mla
    c_kv, k_pe = (x @ p.w_dkv).split([m.kv_lora_rank, m.rope_head_dim],
                                     dim=-1)
    c_kv = rms_norm(c_kv, p.kv_norm, cfg.norm_eps)
    k_pe = apply_rope(k_pe[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return c_kv, k_pe  # [B,S,kv_lora], [B,S,rope_dim]


def _mla_scale(cfg) -> float:
    return 1.0 / math.sqrt(cfg.mla.nope_head_dim + cfg.mla.rope_head_dim)


def mla_attention(p, x, cfg, positions):
    """Full-sequence MLA (prefill), K/V expanded explicitly.  Returns
    (out, (c_kv, k_pe) latent cache)."""
    S = x.shape[1]
    q_nope, q_pe = _mla_q(p, x, cfg, positions)
    c_kv, k_pe = _mla_latent(p, x, cfg, positions)
    k_nope = einsum("bsc,chd->bshd", c_kv, p.w_uk)
    v = einsum("bsc,chd->bshd", c_kv, p.w_uv)
    scores = (einsum("bqhd,bkhd->bhqk", q_nope, k_nope, torch.float32) +
              einsum("bqhd,bkd->bhqk", q_pe, k_pe, torch.float32)
              ) * _mla_scale(cfg)
    mask = causal_mask(S, S, 0, device=x.device)
    scores = scores.masked_fill(~mask[:, None], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    return _project_out(out, p.wo), (c_kv, k_pe)


def mla_decode(p, x, cache_c, cache_pe, cache_len: int, cfg):
    """Absorbed-product MLA decode: scores and values in latent space (the
    cache is kv_lora + rope wide).  Writes the new latent at ``cache_len``
    into ``cache_c``/``cache_pe`` [B,S_max,C] in place and returns the
    output [B,1,d_model].  AES-KV samples latent positions when set."""
    B = x.shape[0]
    S_max = cache_c.shape[1]
    positions = torch.full((B, 1), cache_len, device=x.device)
    q_nope, q_pe = _mla_q(p, x, cfg, positions)
    c_new, pe_new = _mla_latent(p, x, cfg, positions)
    cache_c[:, cache_len] = c_new[:, 0]
    cache_pe[:, cache_len] = pe_new[:, 0]

    c, pe = cache_c, cache_pe
    idx = _sampled_positions(cfg, S_max, x.device)
    if idx is not None:
        c, pe = cache_c[:, idx], cache_pe[:, idx]
        kpos = idx[None, :]
    else:
        kpos = torch.arange(S_max, device=x.device)[None, :]

    q_lat = einsum("bqhd,chd->bqhc", q_nope, p.w_uk)
    scores = (einsum("bqhc,bkc->bhqk", q_lat, c, torch.float32) +
              einsum("bqhd,bkd->bhqk", q_pe, pe, torch.float32)
              ) * _mla_scale(cfg)
    valid = kpos <= cache_len
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(c.dtype)
    out_lat = torch.einsum("bhqk,bkc->bqhc", w, c)
    out = einsum("bqhc,chd->bqhd", out_lat, p.w_uv)
    return _project_out(out, p.wo)
