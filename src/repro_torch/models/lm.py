"""LM assembly for the uniform architectures (dense, sliding window, MoE,
MLA, and the two frontend stubs through ``embeds=``) behind one API::

    model         = init_params(cfg, seed, device=...)      # an LM module
    logits, aux, cache = forward(model, cfg, tokens=... | embeds=...,
                                 want_cache=True)
    cache         = init_cache(cfg, batch, seq, device=...)
    logits, cache = decode_step(model, cfg, cache, tokens=... | embeds=...,
                                cache_len=n)
    specs         = input_specs(cfg, shape_kind, seq, batch)

The reference stacks the layers' parameters on a leading axis and scans
them; here they are a ``ModuleList`` run in a Python loop, while the KV
cache keeps the stacked layout ``[L, B, S, ...]`` (decode writes each
layer's slice in place).  ``cfg`` is passed beside the model, so one set
of weights serves with AES-KV, the int8 cache or neither.

The pattern families (``block_pattern``: xLSTM, Zamba2) are not ported
yet and raise ``NotImplementedError``; so does training (``loss_fn``).
"""
from __future__ import annotations

import math

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (ParamTree, dense_init, dtype_of,
                                       init_mlp, mlp, rms_norm, zeros)

#: the sequence axis of every entry of a uniform cache ([L, B, S, ...])
CACHE_SEQ_AXIS = {"k": 2, "v": 2, "k_scale": 2, "v_scale": 2,
                  "c_kv": 2, "k_pe": 2}


def require_uniform(cfg: ArchConfig) -> None:
    if cfg.block_pattern is not None:
        raise NotImplementedError(
            f"{cfg.name}: the pattern families (block_pattern: Mamba2, "
            "mLSTM/sLSTM, shared attention; models/ssm.py, models/xlstm.py) "
            "are the next slice of the port")


class LM(ParamTree):
    """A uniform LM's parameters under the reference's names: ``embed``,
    ``final_norm``, ``lm_head`` (untied heads) and ``layers``, a
    ``ModuleList`` of ``ln1``, ``ln2``, ``attn`` and ``mlp`` or ``moe``."""


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_uniform_layer(gen: torch.Generator, cfg: ArchConfig) -> dict:
    p = {"ln1": zeros(gen, (cfg.d_model,), torch.float32),
         "ln2": zeros(gen, (cfg.d_model,), torch.float32)}
    p["attn"] = (attn_mod.init_mla(gen, cfg) if cfg.mla is not None
                 else attn_mod.init_attention(gen, cfg))
    if cfg.moe is not None:
        p["moe"] = moe_mod.init_moe(gen, cfg)
    else:
        p["mlp"] = init_mlp(gen, cfg)
    return p


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None) -> LM:
    """Random weights drawn on ``device`` (default ``"cuda"``) from a
    ``torch.Generator`` seeded with ``seed``; float32 draws cast to
    ``cfg.param_dtype``, the reference's scales."""
    require_uniform(cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    dt = dtype_of(cfg)
    tree = {"embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), dt,
                                scale=1.0),
            "final_norm": zeros(gen, (cfg.d_model,), torch.float32)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    tree["layers"] = [_init_uniform_layer(gen, cfg)
                      for _ in range(cfg.num_layers)]
    return LM(tree)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, seq: int, *, device=None) -> dict:
    """Empty decode cache on ``device`` (default ``"cuda"``): bfloat16 K/V
    (a ring of ``sliding_window`` positions for SWA), or int8 K/V with
    float32 scales a (position, head), or MLA's latent ``c_kv``/``k_pe``."""
    require_uniform(cfg)
    device = resolve_device(device)
    dt = torch.bfloat16
    L = cfg.num_layers
    hd = cfg.resolved_head_dim

    def z(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if cfg.mla is not None:
        m = cfg.mla
        return {"c_kv": z(L, batch, seq, m.kv_lora_rank),
                "k_pe": z(L, batch, seq, m.rope_head_dim)}
    seq_eff = min(seq, cfg.sliding_window or seq)  # ring buffer for SWA
    kv = (L, batch, seq_eff, cfg.num_kv_heads)
    if cfg.kv_quant_bits:
        return {"k": z(*kv, hd, dtype=torch.int8),
                "v": z(*kv, hd, dtype=torch.int8),
                "k_scale": torch.ones(kv, dtype=torch.float32, device=device),
                "v_scale": torch.ones(kv, dtype=torch.float32, device=device)}
    return {"k": z(*kv, hd), "v": z(*kv, hd)}


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _embed(model: LM, cfg: ArchConfig, tokens=None, embeds=None):
    if embeds is not None:
        return embeds.to(dtype_of(cfg))
    x = model.embed[tokens]
    if cfg.tie_embeddings:  # gemma convention: sqrt(d_model) in x's dtype
        scale = torch.tensor(math.sqrt(cfg.d_model), dtype=torch.float32)
        x = x * float(scale.to(x.dtype))
    return x


def _unembed(model: LM, cfg: ArchConfig, x):
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    head = model.embed.T if cfg.tie_embeddings else model.lm_head
    logits = x @ head
    return logits if cfg.bf16_logits else logits.float()


def _uniform_layer(lp, x, cfg: ArchConfig, positions):
    h = rms_norm(x, lp.ln1, cfg.norm_eps)
    if cfg.mla is not None:
        a, kv = attn_mod.mla_attention(lp.attn, h, cfg, positions)
    else:
        a, kv = attn_mod.attention(lp.attn, h, cfg, positions,
                                   window=cfg.sliding_window)
    x = x + a
    h = rms_norm(x, lp.ln2, cfg.norm_eps)
    if cfg.moe is not None:
        f, aux = moe_mod.moe_mlp(lp.moe, h, cfg, cfg.act)
    else:
        f, aux = mlp(lp.mlp, h, cfg.act), None
    return x + f, aux, kv


def forward(model: LM, cfg: ArchConfig, tokens=None, embeds=None,
            want_cache: bool = False):
    """Full-sequence pass over ``tokens`` [B,S] or ``embeds`` [B,S,d].
    Returns (logits float32 [B,S,V], aux_loss, cache | None); the cache is
    the prompt's K/V (or MLA latents) in bfloat16, ``[L, B, S, ...]``."""
    require_uniform(cfg)
    x = _embed(model, cfg, tokens, embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    kvs = []
    for lp in model.layers:
        x, layer_aux, kv = _uniform_layer(lp, x, cfg, positions)
        if layer_aux is not None:
            aux = aux + layer_aux
        if want_cache:
            kvs.append(kv)
    cache = None
    if want_cache:
        names = ("c_kv", "k_pe") if cfg.mla is not None else ("k", "v")
        cache = {name: torch.stack([kv[i] for kv in kvs]).to(torch.bfloat16)
                 for i, name in enumerate(names)}
    return _unembed(model, cfg, x), aux, cache


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def decode_step(model: LM, cfg: ArchConfig, cache: dict, tokens=None,
                embeds=None, cache_len: int = 0):
    """One-token decode: ``tokens`` [B,1] or ``embeds`` [B,1,d] at
    position ``cache_len`` (a Python int).  Writes each layer's new K/V
    into ``cache`` in place.  Returns (logits float32 [B,1,V], cache)."""
    require_uniform(cfg)
    x = _embed(model, cfg, tokens, embeds)
    for i, lp in enumerate(model.layers):
        h = rms_norm(x, lp.ln1, cfg.norm_eps)
        if cfg.mla is not None:
            a = attn_mod.mla_decode(lp.attn, h, cache["c_kv"][i],
                                    cache["k_pe"][i], cache_len, cfg)
        elif cfg.kv_quant_bits:
            a = attn_mod.attention_decode(
                lp.attn, h, cache["k"][i], cache["v"][i], cache_len, cfg,
                window=cfg.sliding_window, cache_ks=cache["k_scale"][i],
                cache_vs=cache["v_scale"][i])
        else:
            a = attn_mod.attention_decode(
                lp.attn, h, cache["k"][i], cache["v"][i], cache_len, cfg,
                window=cfg.sliding_window)
        x = x + a
        h = rms_norm(x, lp.ln2, cfg.norm_eps)
        if cfg.moe is not None:
            f, _ = moe_mod.moe_mlp(lp.moe, h, cfg, cfg.act)
        else:
            f = mlp(lp.mlp, h, cfg.act)
        x = x + f
    return _unembed(model, cfg, x), cache


def input_specs(cfg: ArchConfig, kind: str, seq: int, batch: int) -> dict:
    """``meta``-device stand-ins for every model input of a shape cell
    (``kind``: "train", "prefill" or "decode")."""
    def f(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    stub = cfg.frontend is not None
    if kind == "train":
        specs = {"labels": f((batch, seq), torch.int32)}
        if stub:
            specs["embeds"] = f((batch, seq, cfg.d_model), torch.bfloat16)
        else:
            specs["tokens"] = f((batch, seq), torch.int32)
        return specs
    if kind == "prefill":
        if stub:
            return {"embeds": f((batch, seq, cfg.d_model), torch.bfloat16)}
        return {"tokens": f((batch, seq), torch.int32)}
    if kind == "decode":
        specs = {"cache": init_cache(cfg, batch, seq, device="meta"),
                 "cache_len": f((), torch.int32)}
        if stub:
            specs["embeds"] = f((batch, 1, cfg.d_model), torch.bfloat16)
        else:
            specs["tokens"] = f((batch, 1), torch.int32)
        return specs
    raise ValueError(kind)
