"""The port's LM blocks (``repro_torch.models.{layers,attention,moe}``)
against the reference's, on the same numpy inputs and weights.

Tolerances: float32 blocks to 1e-5 (only the summation order differs);
decode attention over a bfloat16 cache to 2e-3, the reference's own
decode tolerance (tests/test_model_blocks.py), since its softmax weights
and output are bfloat16 there; integers bit-equal (``aes_kv_indices``,
``quantize_kv``'s ``q``, and its scale, one IEEE division away from the
same maximum).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import moe
from repro_torch.models.layers import ParamTree

TOL = 1e-5
DEC_TOL = 2e-3


def configs(arch: str, **options):
    kw = dict(param_dtype="float32", **options)
    return (ref_smoke_config(ref_get_config(arch)).with_options(**kw),
            smoke_config(get_config(arch)).with_options(**kw))


def weights(shapes: dict, seed: int, experts: bool = False) -> dict:
    """numpy weights for a block's parameter dict of ``shapes``: matrices
    at 1/sqrt(fan-in) (``experts``: 3-D tensors lead with the expert
    axis), vectors at 0.1."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in shapes.items():
        if isinstance(shape, dict):
            out[name] = weights(shape, seed + 1)
            continue
        fan_in = shape[1] if experts and len(shape) == 3 else shape[0]
        scale = 1.0 / np.sqrt(fan_in) if len(shape) >= 2 else 0.1
        out[name] = (rng.normal(size=shape) * scale).astype(np.float32)
    return out


def shapes_of(init_fn, cfg) -> dict:
    """The parameter shapes of a port init function's dict."""
    gen = torch.Generator().manual_seed(0)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    return walk(init_fn(gen, cfg))


def both(tree: dict):
    """(reference params, port params) on the same numpy weights."""
    def to_jax(t):
        return {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(v)
                for k, v in t.items()}

    def to_torch(t):
        return {k: to_torch(v) if isinstance(v, dict) else
                torch.from_numpy(v.copy()) for k, v in t.items()}

    return to_jax(tree), ParamTree(to_torch(tree))


def close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def positions(B: int, S: int, start: int = 0):
    p = np.broadcast_to(np.arange(start, start + S)[None], (B, S))
    return jnp.asarray(p), torch.from_numpy(p.copy())


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 64)).astype(np.float32) * 3
    g = rng.normal(size=64).astype(np.float32) * 0.1
    close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-6),
          ref_layers.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6))
    # bfloat16 in, bfloat16 out, float32 inside
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = layers.rms_norm(xb, torch.from_numpy(g))
    assert got.dtype == torch.bfloat16
    want = ref_layers.rms_norm(jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(g))
    close(got, want, 2.0 ** -7)
    for theta in (10_000.0, 1_000_000.0):
        pj, pt = positions(2, 5, start=1000)
        close(layers.apply_rope(torch.from_numpy(x), pt, theta),
              ref_layers.apply_rope(jnp.asarray(x), pj, theta), 1e-4)


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (8, 1)])
def test_gqa_attention_matches_reference(H, KV):
    ref_cfg, cfg = configs("qwen2-7b", num_heads=H, num_kv_heads=KV,
                           head_dim=16)
    ref_p, p = both(weights(shapes_of(attn.init_attention, cfg), H + KV))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    pj, pt = positions(2, 12)
    want, (wk, wv) = ref_attn.attention(ref_p, jnp.asarray(x), ref_cfg, pj)
    got, (k, v) = attn.attention(p, torch.from_numpy(x), cfg, pt)
    close(got, want)
    close(k, wk)
    close(v, wv)


def test_sliding_window_mask_matches_reference():
    for Sq, Sk, off, window in [(6, 6, 0, 3), (6, 6, 0, None), (1, 9, 8, 4),
                                (4, 10, 6, 16)]:
        want = np.asarray(ref_attn.causal_mask(Sq, Sk, off, window=window))
        got = attn.causal_mask(Sq, Sk, off, window=window).numpy()
        np.testing.assert_array_equal(got, want)
    m = attn.causal_mask(6, 6, 0, window=3)[0]
    assert m[5, 5] and m[5, 3] and not m[5, 2] and not m[0, 1]


def test_aes_kv_indices_bit_equal():
    """Every band of the strategy table, W >= seq, and W = 1."""
    for seq in (1, 2, 7, 16, 33, 64, 100, 257, 1088, 2048, 5000):
        for width in (1, 3, 8, 16, 31, 64, 128, 256, 1088, 4096):
            want = ref_attn.aes_kv_indices(seq, width)
            got = attn.aes_kv_indices(seq, width)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            if width < seq:
                np.testing.assert_array_equal(
                    attn.aes_kv_index(seq, width, torch.device("cpu")
                                      ).numpy(), want)


def test_quantize_kv_bit_equal():
    """``q`` and the scale bit for bit, on float32 and bfloat16 rows, with
    halves that round to even, an all-zero row (the 1e-8 floor) and a
    one-hot row; the dequantized rows equal."""
    rng = np.random.default_rng(2)
    t = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    t[0, 0, 0] = 0.0
    t[0, 1, 1] = 0.0
    t[0, 1, 1, 3] = -2.5
    t[1, 2, 0] = np.arange(32, dtype=np.float32) * (127 / 31) - 63.5
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        tt = torch.from_numpy(t).to(dtype)
        q, s = attn.quantize_kv(tt)
        wq, ws = ref_attn.quantize_kv(jnp.asarray(t).astype(jdtype))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
        np.testing.assert_array_equal(
            attn.dequantize_kv(q, s).float().numpy(),
            np.asarray(ref_attn.dequantize_kv(wq, ws), np.float32))


@pytest.mark.parametrize("case", ["full", "aes", "int8", "int8-aes", "ring"])
def test_attention_decode_matches_reference(case):
    """One decode step at ``cache_len`` 20 of a 32-position bfloat16
    cache (int8 with scales for the int8 cases): output and written
    cache.  ``aes`` samples 8 positions; ``ring`` is a window of 32 over
    a 32-slot ring at ``cache_len`` 37 (the write wraps to slot 5)."""
    opts = {"aes": {"aes_kv_width": 8}, "int8": {"kv_quant_bits": 8},
            "int8-aes": {"kv_quant_bits": 8, "aes_kv_width": 8},
            "ring": {"sliding_window": 32}}.get(case, {})
    ref_cfg, cfg = configs("qwen2-7b", **opts)
    ref_p, p = both(weights(shapes_of(attn.init_attention, cfg), 3))
    rng = np.random.default_rng(4)
    B, S_max, n = 2, 32, (37 if case == "ring" else 20)
    x = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    kv = rng.normal(size=(2, B, S_max, cfg.num_kv_heads,
                          cfg.resolved_head_dim)).astype(np.float32)
    ck, cv = (jnp.asarray(a).astype(jnp.bfloat16) for a in kv)
    kw = {"window": cfg.sliding_window}
    ref_kw = dict(kw)
    if cfg.kv_quant_bits:
        (ck, ks), (cv, vs) = ref_attn.quantize_kv(ck), ref_attn.quantize_kv(cv)
        ref_kw.update(cache_ks=ks, cache_vs=vs)
    port = {k: torch.from_numpy(np.asarray(v, np.float32)).to(torch.bfloat16)
            if v.dtype == jnp.bfloat16 else torch.from_numpy(np.array(v))
            for k, v in dict(ck=ck, cv=cv, **{
                k: v for k, v in ref_kw.items() if k != "window"}).items()}
    want = ref_attn.attention_decode(ref_p, jnp.asarray(x), ck, cv,
                                     jnp.int32(n), ref_cfg, **ref_kw)
    got = attn.attention_decode(
        p, torch.from_numpy(x), port["ck"], port["cv"], n, cfg, **kw,
        **{k: port[k] for k in ("cache_ks", "cache_vs") if k in port})
    close(got, want[0], DEC_TOL)
    for name, w in zip(("ck", "cv", "cache_ks", "cache_vs"), want[1:]):
        np.testing.assert_allclose(port[name].float().numpy(),
                                   np.asarray(w, np.float32),
                                   rtol=2.0 ** -7, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("width", [None, 4])
def test_mla_prefill_and_decode_match_reference(width):
    """MLA prefill (output and latent cache), then the absorbed decode of
    the last position from the prefill's first S-1 latents, with full
    attention or AES-KV over 4 of the 8 latent positions."""
    ref_cfg, cfg = configs("deepseek-v2-236b", aes_kv_width=width)
    ref_p, p = both(weights(shapes_of(attn.init_mla, cfg), 5))
    rng = np.random.default_rng(6)
    B, S = 2, 8
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pj, pt = positions(B, S)
    want, (wc, wpe) = ref_attn.mla_attention(ref_p, jnp.asarray(x), ref_cfg,
                                             pj)
    got, (c, pe) = attn.mla_attention(p, torch.from_numpy(x), cfg, pt)
    close(got, want)
    close(c, wc)
    close(pe, wpe)

    cc = jnp.zeros((B, S, cfg.mla.kv_lora_rank), jnp.bfloat16).at[
        :, :S - 1].set(wc[:, :S - 1].astype(jnp.bfloat16))
    cp = jnp.zeros((B, S, cfg.mla.rope_head_dim), jnp.bfloat16).at[
        :, :S - 1].set(wpe[:, :S - 1].astype(jnp.bfloat16))
    tc = torch.from_numpy(np.asarray(cc, np.float32)).to(torch.bfloat16)
    tp = torch.from_numpy(np.asarray(cp, np.float32)).to(torch.bfloat16)
    dec, c2, p2 = ref_attn.mla_decode(ref_p, jnp.asarray(x[:, S - 1:]), cc,
                                      cp, jnp.int32(S - 1), ref_cfg)
    got = attn.mla_decode(p, torch.from_numpy(x[:, S - 1:]), tc, tp, S - 1,
                          cfg)
    close(got, dec, DEC_TOL)
    close(tc, c2, 2.0 ** -7)
    close(tp, p2, 2.0 ** -7)


@pytest.mark.parametrize("arch,act", [("mixtral-8x22b", "silu"),
                                      ("deepseek-v2-236b", "gelu")])
def test_moe_mlp_matches_reference(arch, act):
    """Routing, the grouped products, the weighted combine and the Switch
    auxiliary; DeepSeek's adds a shared expert (GeGLU here to reach the
    tanh GELU)."""
    ref_cfg, cfg = configs(arch)
    ref_p, p = both(weights(shapes_of(moe.init_moe, cfg), 7, experts=True))
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    want, waux = ref_moe.moe_mlp(ref_p, jnp.asarray(x), ref_cfg, act)
    got, aux = moe.moe_mlp(p, torch.from_numpy(x), cfg, act)
    close(got, want)
    np.testing.assert_allclose(float(aux), float(waux), rtol=TOL)
