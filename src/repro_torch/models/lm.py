"""LM assembly: every assigned architecture behind one API::

    model         = init_params(cfg, seed, device=...)      # an LM module
    logits, aux, cache = forward(model, cfg, tokens=... | embeds=...,
                                 want_cache=True, remat=True)
    cache         = init_cache(cfg, batch, seq, device=...)
    logits, cache = decode_step(model, cfg, cache, tokens=... | embeds=...,
                                cache_len=n)
    loss          = loss_fn(model, cfg, batch)
    specs         = input_specs(cfg, shape_kind, seq, batch)

Three layouts, as in the reference:

- uniform (dense, sliding window, MoE, MLA, the frontend stubs through
  ``embeds=``): ``layers``, a ``ModuleList`` run in a Python loop where
  the reference scans stacked parameters; the cache keeps the stacked
  layout ``[L, B, S, ...]``;
- grouped (Zamba2: ``block_pattern`` with ``attn_every > 0``): ``groups``
  of ``attn_every - 1`` Mamba blocks and one application of the
  weight-shared attention + MLP (``shared_attn``, ``shared_mlp``), then
  a ``tail`` of Mamba blocks; the cache stacks the groups' states
  ``[G, per, ...]`` and K/V ``[G, B, S, ...]`` as the reference's;
- pattern (xLSTM, or a ``block_pattern`` with ``attn_every == 0``):
  ``blocks`` in pattern order (a ``shared_attn`` entry holds no
  parameters: it applies ``shared_attn``/``shared_mlp``) with
  ``block_norms``; the cache is a list of per-block entries.

Decode writes K/V, recurrent states and conv caches into ``cache`` in
place.  ``cfg`` is passed beside the model, so one set of weights serves
with AES-KV, the int8 cache or neither.  ``forward(remat=True)`` wraps
each uniform layer and each group in ``torch.utils.checkpoint`` while
gradients are recorded (``cfg.remat_policy``: None recomputes all,
``"dots"`` saves the matmul outputs, ``"nothing"`` turns it off), as the
reference wraps its scan bodies in ``jax.checkpoint``.
"""
from __future__ import annotations

import functools
import math

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.layers import (ParamTree, dense_init, dtype_of,
                                       init_mlp, mlp, rms_norm, zeros)

#: the sequence axis of every attention cache entry, counted from the end
#: (the same in a uniform, grouped or per-block cache)
CACHE_SEQ_AXIS = {"k": -3, "v": -3, "k_scale": -2, "v_scale": -2,
                  "c_kv": -2, "k_pe": -2}


def _is_uniform(cfg: ArchConfig) -> bool:
    return cfg.block_pattern is None


def _is_grouped(cfg: ArchConfig) -> bool:
    """Periodic hybrid (Zamba2): groups of ``attn_every - 1`` Mamba blocks
    and one weight-shared attention block."""
    return cfg.block_pattern is not None and cfg.attn_every > 0


def _group_layout(cfg: ArchConfig) -> tuple[int, int, int]:
    """(num_groups, mamba_per_group, tail_mamba)."""
    per = cfg.attn_every
    g = cfg.num_layers // per
    return g, per - 1, cfg.num_layers - g * per


class LM(ParamTree):
    """An LM's parameters under the reference's names: ``embed``,
    ``final_norm``, ``lm_head`` (untied heads), and ``layers`` (uniform),
    ``groups``/``tail``/``shared_attn``/``shared_mlp`` (grouped) or
    ``blocks``/``block_norms`` (pattern).

    Calling the module runs ``fn(module, *args, **kwargs)``, so that
    ``torch.func.functional_call(model, params, (loss_fn, cfg, batch))``
    runs any function of this file on substituted parameters."""

    def forward(self, fn, *args, **kwargs):
        return fn(self, *args, **kwargs)


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


_INIT_BLOCK = {"mamba": ssm_mod.init_mamba, "mlstm": xlstm_mod.init_mlstm,
               "slstm": xlstm_mod.init_slstm}


def _init_block(gen: torch.Generator, cfg: ArchConfig, kind: str) -> dict:
    if kind == "shared_attn":
        return {}  # weights shared, stored once
    if kind not in _INIT_BLOCK:
        raise ValueError(f"unknown block kind {kind!r}")
    return _INIT_BLOCK[kind](gen, cfg)


def init_params(cfg: ArchConfig, seed: int = 0, *, device=None) -> LM:
    """Random weights drawn on ``device`` (default ``"cuda"``) from a
    ``torch.Generator`` seeded with ``seed``; float32 draws cast to
    ``cfg.param_dtype``, the reference's scales."""
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    dt = dtype_of(cfg)
    d = cfg.d_model
    tree = {"embed": dense_init(gen, (cfg.vocab_size, d), dt, scale=1.0),
            "final_norm": zeros(gen, (d,), torch.float32)}
    if not cfg.tie_embeddings:
        tree["lm_head"] = dense_init(gen, (d, cfg.vocab_size), dt)
    if _is_uniform(cfg):
        tree["layers"] = [_init_uniform_layer(gen, cfg)
                          for _ in range(cfg.num_layers)]
        return LM(tree)
    if _is_grouped(cfg):
        G, per, tail = _group_layout(cfg)
        tree["groups"] = [
            {"mamba": [ssm_mod.init_mamba(gen, cfg) for _ in range(per)],
             "norms": zeros(gen, (per + 1, d), torch.float32)}
            for _ in range(G)]
        if tail:
            tree["tail"] = {
                "mamba": [ssm_mod.init_mamba(gen, cfg) for _ in range(tail)],
                "norms": zeros(gen, (tail, d), torch.float32)}
    else:
        tree["blocks"] = [_init_block(gen, cfg, kind)
                          for kind in cfg.block_pattern]
        tree["block_norms"] = [zeros(gen, (d,), torch.float32)
                               for _ in cfg.block_pattern]
    if _is_grouped(cfg) or "shared_attn" in cfg.block_pattern:
        tree["shared_attn"] = attn_mod.init_attention(gen, cfg)
        tree["shared_mlp"] = init_mlp(gen, cfg)
    return LM(tree)


# ---------------------------------------------------------------------------
# cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, seq: int, *, device=None) -> dict:
    """Empty decode cache on ``device`` (default ``"cuda"``), under the
    reference's names and shapes: bfloat16 K/V (a ring of
    ``sliding_window`` positions for SWA), or int8 K/V with float32
    scales a (position, head), or MLA's latent ``c_kv``/``k_pe``; for the
    grouped and pattern layouts, float32 recurrent states, bfloat16 conv
    caches and the shared attention's K/V."""
    device = resolve_device(device)
    dt, f32 = torch.bfloat16, torch.float32
    L = cfg.num_layers
    hd = cfg.resolved_head_dim

    def z(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    if _is_uniform(cfg):
        if cfg.mla is not None:
            m = cfg.mla
            return {"c_kv": z(L, batch, seq, m.kv_lora_rank),
                    "k_pe": z(L, batch, seq, m.rope_head_dim)}
        seq_eff = min(seq, cfg.sliding_window or seq)  # ring buffer for SWA
        kv = (L, batch, seq_eff, cfg.num_kv_heads)
        if cfg.kv_quant_bits:
            return {"k": z(*kv, hd, dtype=torch.int8),
                    "v": z(*kv, hd, dtype=torch.int8),
                    "k_scale": torch.ones(kv, dtype=f32, device=device),
                    "v_scale": torch.ones(kv, dtype=f32, device=device)}
        return {"k": z(*kv, hd), "v": z(*kv, hd)}

    H, n, K = cfg.num_heads, cfg.ssm_state, cfg.ssm_conv
    hdm = cfg.ssm_expand * cfg.d_model // H
    n_attn_seq = min(seq, cfg.sliding_window or seq)

    def mamba_cache(*lead):
        return {"state": z(*lead, batch, H, hdm, n, dtype=f32),
                "conv": {"x": z(*lead, batch, K - 1, H, hdm),
                         "B": z(*lead, batch, K - 1, n),
                         "C": z(*lead, batch, K - 1, n)}}

    def kv_cache(*lead):
        return z(*lead, batch, n_attn_seq, cfg.num_kv_heads, hd)

    if _is_grouped(cfg):
        G, per, tail = _group_layout(cfg)
        cache = {"groups": {"mamba": mamba_cache(G, per), "k": kv_cache(G),
                            "v": kv_cache(G)}}
        if tail:
            cache["tail"] = mamba_cache(tail)
        return cache
    blocks = []
    for kind in cfg.block_pattern:
        if kind == "mamba":
            blocks.append(mamba_cache())
        elif kind == "mlstm":
            blocks.append({"C": z(batch, H, hdm, hdm + 1, dtype=f32)})
        elif kind == "slstm":
            d = cfg.d_model
            blocks.append({"c": z(batch, d, dtype=f32),
                           "n": torch.ones((batch, d), dtype=f32,
                                           device=device),
                           "h": z(batch, d, dtype=f32)})
        elif kind == "shared_attn":
            blocks.append({"k": kv_cache(), "v": kv_cache()})
    return {"blocks": blocks}


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

#: ``remat_policy="dots"``: the products without batch dimensions (the
#: weight projections) are saved, the rest recomputed — the reference's
#: ``dots_with_no_batch_dims_saveable``
_SAVED_PRODUCTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _remat(body, cfg: ArchConfig):
    """``body`` under ``torch.utils.checkpoint`` with the config's policy:
    the default keeps only the call's inputs (full recompute), ``"dots"``
    also the matmul outputs, ``"nothing"`` returns ``body`` itself."""
    if cfg.remat_policy == "nothing":
        return body
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _SAVED_PRODUCTS)
                  if cfg.remat_policy == "dots" else noop_context_fn)
    return functools.partial(checkpoint, body, use_reentrant=False,
                             context_fn=context_fn)


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


def _shared_block(model: LM, x, norm, cfg: ArchConfig, positions):
    """The weight-shared attention + MLP with one norm used twice, as the
    reference writes it: ``y = a + mlp(norm(x + a))``, the residual
    ``x + y`` left to the caller.  Returns (y, (k, v))."""
    h = rms_norm(x, norm, cfg.norm_eps)
    a, kv = attn_mod.attention(model.shared_attn, h, cfg, positions,
                               window=cfg.sliding_window)
    y = a + mlp(model.shared_mlp, rms_norm(x + a, norm, cfg.norm_eps),
                cfg.act)
    return y, kv


def _mamba_layer(mp, x, norm, cfg: ArchConfig):
    y, state, conv = ssm_mod.mamba_block(mp, rms_norm(x, norm, cfg.norm_eps),
                                         cfg)
    return x + y, state, conv


def _group(model: LM, gp, x, cfg: ArchConfig, positions):
    """One Zamba2 group: its Mamba blocks, then the shared block.
    Returns (x, states, conv caches, (k, v))."""
    states, convs = [], []
    for j, mp in enumerate(gp.mamba):
        x, state, conv = _mamba_layer(mp, x, gp.norms[j], cfg)
        states.append(state)
        convs.append(conv)
    y, kv = _shared_block(model, x, gp.norms[len(gp.mamba)], cfg, positions)
    return x + y, states, convs, kv


def _bf16(t):
    return t.to(torch.bfloat16)


def _stack_mamba(states: list, convs: list) -> dict:
    """Per-block states and conv caches as one cache entry stacked on a
    leading axis (conv caches in bfloat16)."""
    return {"state": torch.stack(states),
            "conv": {k: _bf16(torch.stack([c[k] for c in convs]))
                     for k in convs[0]}}


def forward(model: LM, cfg: ArchConfig, tokens=None, embeds=None,
            want_cache: bool = False, remat: bool = True):
    """Full-sequence pass over ``tokens`` [B,S] or ``embeds`` [B,S,d].
    Returns (logits float32 [B,S,V], aux_loss, cache | None); the cache
    holds the prompt's K/V (or MLA latents) in bfloat16 and, for the
    recurrent blocks, their final states.  ``remat`` checkpoints each
    uniform layer and each group while gradients are recorded."""
    x = _embed(model, cfg, tokens, embeds)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = remat and torch.is_grad_enabled()

    if _is_uniform(cfg):
        layer = _remat(_uniform_layer, cfg) if remat else _uniform_layer
        kvs = []
        for lp in model.layers:
            x, layer_aux, kv = layer(lp, x, cfg, positions)
            if layer_aux is not None:
                aux = aux + layer_aux
            if want_cache:
                kvs.append(kv)
        cache = None
        if want_cache:
            names = ("c_kv", "k_pe") if cfg.mla is not None else ("k", "v")
            cache = {name: _bf16(torch.stack([kv[i] for kv in kvs]))
                     for i, name in enumerate(names)}
        return _unembed(model, cfg, x), aux, cache

    if _is_grouped(cfg):
        group = _remat(_group, cfg) if remat else _group
        outs = []
        for gp in model.groups:
            x, states, convs, kv = group(model, gp, x, cfg, positions)
            outs.append((states, convs, kv))
        tail_states, tail_convs = [], []
        if hasattr(model, "tail"):
            for j, mp in enumerate(model.tail.mamba):
                x, state, conv = _mamba_layer(mp, x, model.tail.norms[j], cfg)
                tail_states.append(state)
                tail_convs.append(conv)
        cache = None
        if want_cache:
            per = [_stack_mamba(states, convs) for states, convs, _ in outs]
            cache = {"groups": {
                "mamba": {"state": torch.stack([m["state"] for m in per]),
                          "conv": {k: torch.stack([m["conv"][k] for m in per])
                                   for k in per[0]["conv"]}},
                "k": _bf16(torch.stack([kv[0] for _, _, kv in outs])),
                "v": _bf16(torch.stack([kv[1] for _, _, kv in outs]))}}
            if tail_states:
                cache["tail"] = _stack_mamba(tail_states, tail_convs)
        return _unembed(model, cfg, x), aux, cache

    entries = []
    for i, kind in enumerate(cfg.block_pattern):
        bp, norm = model.blocks[i], model.block_norms[i]
        h = rms_norm(x, norm, cfg.norm_eps)
        if kind == "mamba":
            y, state, conv = ssm_mod.mamba_block(bp, h, cfg)
            entry = {"state": state,
                     "conv": {k: _bf16(c) for k, c in conv.items()}}
        elif kind == "mlstm":
            y, state = xlstm_mod.mlstm_block(bp, h, cfg)
            entry = {"C": state}
        elif kind == "slstm":
            y, (c, n, hh) = xlstm_mod.slstm_block(bp, h, cfg)
            entry = {"c": c, "n": n, "h": hh}
        else:  # shared_attn
            y, kv = _shared_block(model, x, norm, cfg, positions)
            entry = {"k": _bf16(kv[0]), "v": _bf16(kv[1])}
        x = x + y
        entries.append(entry)
    return (_unembed(model, cfg, x), aux,
            {"blocks": entries} if want_cache else None)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _decode_mamba(mp, x, norm, ck: dict, cfg: ArchConfig):
    """One Mamba block's decode step; writes its state and conv caches
    into ``ck`` (views into the cache) in place."""
    y, state, conv = ssm_mod.mamba_block(
        mp, rms_norm(x, norm, cfg.norm_eps), cfg, state=ck["state"],
        conv_cache=ck["conv"])
    ck["state"].copy_(state)
    for name, c in conv.items():
        ck["conv"][name].copy_(c)
    return x + y


def _decode_shared(model: LM, x, norm, k, v, cache_len: int,
                   cfg: ArchConfig):
    h = rms_norm(x, norm, cfg.norm_eps)
    a = attn_mod.attention_decode(model.shared_attn, h, k, v, cache_len, cfg,
                                  window=cfg.sliding_window)
    y = a + mlp(model.shared_mlp, rms_norm(x + a, norm, cfg.norm_eps),
                cfg.act)
    return x + y


def _mamba_views(entry: dict, *index) -> dict:
    return {"state": entry["state"][index],
            "conv": {k: c[index] for k, c in entry["conv"].items()}}


def decode_step(model: LM, cfg: ArchConfig, cache: dict, tokens=None,
                embeds=None, cache_len: int = 0):
    """One-token decode: ``tokens`` [B,1] or ``embeds`` [B,1,d] at
    position ``cache_len`` (a Python int).  Writes each layer's new K/V,
    state and conv cache into ``cache`` in place.  Returns (logits
    float32 [B,1,V], cache)."""
    x = _embed(model, cfg, tokens, embeds)
    if _is_uniform(cfg):
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

    if _is_grouped(cfg):
        gc = cache["groups"]
        for g, gp in enumerate(model.groups):
            for j, mp in enumerate(gp.mamba):
                x = _decode_mamba(mp, x, gp.norms[j],
                                  _mamba_views(gc["mamba"], g, j), cfg)
            x = _decode_shared(model, x, gp.norms[len(gp.mamba)], gc["k"][g],
                               gc["v"][g], cache_len, cfg)
        if hasattr(model, "tail"):
            for j, mp in enumerate(model.tail.mamba):
                x = _decode_mamba(mp, x, model.tail.norms[j],
                                  _mamba_views(cache["tail"], j), cfg)
        return _unembed(model, cfg, x), cache

    for i, kind in enumerate(cfg.block_pattern):
        bp, norm = model.blocks[i], model.block_norms[i]
        ck = cache["blocks"][i]
        if kind == "mamba":
            x = _decode_mamba(bp, x, norm, ck, cfg)
        elif kind == "shared_attn":
            x = _decode_shared(model, x, norm, ck["k"], ck["v"], cache_len,
                               cfg)
        elif kind == "mlstm":
            y, state = xlstm_mod.mlstm_block(
                bp, rms_norm(x, norm, cfg.norm_eps), cfg, state=ck["C"])
            ck["C"].copy_(state)
            x = x + y
        else:  # slstm
            y, state = xlstm_mod.slstm_block(
                bp, rms_norm(x, norm, cfg.norm_eps), cfg,
                state=(ck["c"], ck["n"], ck["h"]))
            for name, t in zip("cnh", state):
                ck[name].copy_(t)
            x = x + y
    return _unembed(model, cfg, x), cache


# ---------------------------------------------------------------------------
# loss / specs
# ---------------------------------------------------------------------------

def loss_fn(model: LM, cfg: ArchConfig, batch: dict, aux_weight: float = 0.01):
    """Masked next-token cross entropy (labels < 0 are masked) plus
    ``aux_weight`` times the MoE load-balance loss; ``forward`` under
    ``cfg.remat_policy``."""
    logits, aux, _ = forward(model, cfg, tokens=batch.get("tokens"),
                             embeds=batch.get("embeds"))
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce + aux_weight * aux


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
