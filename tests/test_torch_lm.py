"""The port's LM (``repro_torch.models``) against the reference's
(``repro.models``) for each uniform architecture's smoke config in
float32: the same weights, drawn from numpy seeds in the reference's
layout and given to the port through ``params_from_numpy``.

Tolerances: ``forward``'s logits to 1e-4 (float32 throughout, only the
summation order differs).  Decode reads a bfloat16 cache, so its softmax
weights and attention output are bfloat16 too, as in the reference: each
``decode_step``'s logits to 2e-3, the reference's own decode-vs-prefill
tolerance (tests/test_model_blocks.py).  A last-bit difference before a
cast to the cache can move a cached element by one bfloat16 step
(``rtol=2**-7``, one step of bfloat16's 8-bit significand), which the
cache comparisons allow.  One such step moves a smoke model's logits by
up to 2e-2, so each decode step starts from the reference's cache, and no
difference carries from step to step.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.models import decode_step as ref_decode_step
from repro.models import forward as ref_forward
from repro.models import init_cache as ref_init_cache
from repro.models import init_params as ref_init_params
from repro.models.attention import quantize_kv as ref_quantize_kv
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config, smoke_config
from repro_torch.models import (decode_step, forward, init_cache,
                                input_specs)
from repro_torch.models.convert import params_from_numpy

UNIFORM = ["tinyllama-1.1b", "qwen1.5-0.5b", "qwen2-7b", "gemma-7b",
           "mixtral-8x22b", "deepseek-v2-236b", "pixtral-12b",
           "musicgen-large"]
CPU = torch.device("cpu")
TOL = 1e-4
DEC_TOL = 2e-3
CACHE_RTOL = 2.0 ** -7


def configs(arch: str, **options):
    """(reference config, port config): each package's own smoke config
    of ``arch`` in float32, with ``options``."""
    kw = dict(param_dtype="float32", **options)
    return (ref_smoke_config(ref_get_config(arch)).with_options(**kw),
            smoke_config(get_config(arch)).with_options(**kw))


def numpy_tree(ref_cfg, seed: int) -> dict:
    """Random weights in the reference's parameter layout (from
    ``jax.eval_shape`` of its ``init_params``), drawn from numpy: matrices
    at 1/sqrt(fan-in), vectors (norm gains, biases) at 0.1."""
    shapes = jax.eval_shape(lambda: ref_init_params(ref_cfg,
                                                    jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(shapes)
    layered = {id(leaf) for leaf in jax.tree.leaves(shapes["layers"])}
    out = []
    for leaf in leaves:
        core = leaf.shape[1:] if id(leaf) in layered else leaf.shape
        scale = 1.0 / np.sqrt(core[0]) if len(core) >= 2 else 0.1
        out.append((rng.normal(size=leaf.shape) * scale).astype(
            np.dtype(leaf.dtype)))
    return jax.tree.unflatten(treedef, out)


def both_models(arch: str, seed: int = 0, **options):
    """(ref_cfg, ref_params, cfg, model) on the same numpy weights."""
    ref_cfg, cfg = configs(arch, **options)
    tree = numpy_tree(ref_cfg, seed)
    return (ref_cfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_numpy(cfg, tree, device=CPU))


def inputs(cfg, rng, B: int, S: int) -> dict:
    """Token ids, or frame/patch embeddings for the frontend stubs."""
    if cfg.frontend is not None:
        return {"embeds": rng.normal(size=(B, S, cfg.d_model)
                                     ).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)
                                   ).astype(np.int32)}


def as_torch(d: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in d.items()}


def as_jax(d: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in d.items()}


def cache_to_numpy(cache: dict) -> dict:
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in cache.items()}


def cache_from_jax(cache: dict) -> dict:
    """The reference's cache as the port's tensors, bit for bit."""
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16) if v.dtype == jnp.bfloat16
        else torch.from_numpy(np.array(v)) for k, v in cache.items()}


def assert_cache_close(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, a in cache_to_numpy(got).items():
        np.testing.assert_allclose(a, np.asarray(want[name], np.float32),
                                   rtol=CACHE_RTOL, atol=1e-6, err_msg=name)


def decode_like_reference(ref_params, ref_cfg, ref_cache, model, cfg, rng,
                          B: int, start: int, steps: int):
    """``steps`` decode steps at positions ``start``.. on both packages,
    each from the reference's cache; logits and the updated caches
    compared.  Returns the reference's final cache."""
    for t in range(start, start + steps):
        step = inputs(cfg, rng, B, 1)
        cache = cache_from_jax(ref_cache)
        want, ref_cache = ref_decode_step(ref_params, ref_cfg, ref_cache,
                                          cache_len=jnp.int32(t),
                                          **as_jax(step))
        got, cache = decode_step(model, cfg, cache, cache_len=t,
                                 **as_torch(step))
        assert got.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=DEC_TOL, atol=DEC_TOL)
        assert_cache_close(cache, ref_cache)
    return ref_cache


@pytest.mark.parametrize("arch", UNIFORM)
def test_forward_and_decode_match_reference(arch):
    """Prefill logits and aux loss, the prefill cache, then four decode
    steps from that cache (grown to 8 more positions) against the
    reference's, step by step: with full attention, with AES-KV at
    W = 8 of the 16 positions, and (K/V caches) with AES-KV over the int8
    cache."""
    ref_cfg, ref_params, cfg, model = both_models(arch)
    rng = np.random.default_rng(1)
    B, S, steps = 2, 8, 4
    prompt = inputs(cfg, rng, B, S)
    want, want_aux, want_cache = ref_forward(
        ref_params, ref_cfg, want_cache=True, remat=False,
        **as_jax(prompt))
    got, got_aux, got_cache = forward(model, cfg, want_cache=True,
                                      **as_torch(prompt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5,
                               atol=1e-6)
    assert_cache_close(got_cache, want_cache)
    pad = [(0, 0), (0, 0), (0, 8)]
    ref_cache = {k: jnp.pad(v, pad + [(0, 0)] * (v.ndim - 3))
                 for k, v in want_cache.items()}
    decode_like_reference(ref_params, ref_cfg, ref_cache, model, cfg, rng,
                          B, S, steps=4)

    ref_aes, aes = configs(arch, aes_kv_width=8)
    decode_like_reference(ref_params, ref_aes, ref_cache, model, aes, rng,
                          B, S, steps=4)
    if cfg.mla is None:
        ref_q, q = configs(arch, aes_kv_width=8, kv_quant_bits=8)
        kq, ks = ref_quantize_kv(ref_cache["k"])
        vq, vs = ref_quantize_kv(ref_cache["v"])
        decode_like_reference(
            ref_params, ref_q, {"k": kq, "v": vq, "k_scale": ks,
                                "v_scale": vs},
            model, q, rng, B, S, steps=4)


@pytest.mark.parametrize("arch", UNIFORM)
def test_init_cache_matches_reference(arch):
    """Names, shapes and dtypes of the empty cache, plain and int8 (MLA's
    latent cache has no int8 layout), SWA's ring sized to the window."""
    for options in ({}, {"kv_quant_bits": 8}):
        ref_cfg, cfg = configs(arch, **options)
        want = ref_init_cache(ref_cfg, 2, 40)
        got = init_cache(cfg, 2, 40, device=CPU)
        assert set(got) == set(want)
        for name, a in got.items():
            assert tuple(a.shape) == want[name].shape, name
            assert str(a.dtype).split(".")[-1] == str(want[name].dtype), name
            np.testing.assert_array_equal(
                a.float().numpy(), np.asarray(want[name], np.float32))


def test_sliding_window_ring_wraps_like_reference():
    """Mixtral's window-sized ring (16 positions): 20 decode steps from an
    empty cache, the last four writing over the oldest slots."""
    ref_cfg, ref_params, cfg, model = both_models("mixtral-8x22b", seed=2)
    rng = np.random.default_rng(3)
    ref_cache = ref_init_cache(ref_cfg, 2, 64)
    assert ref_cache["k"].shape[2] == cfg.sliding_window == 16
    decode_like_reference(ref_params, ref_cfg, ref_cache, model, cfg, rng,
                          2, 0, steps=20)


def test_configs_and_input_specs_match_reference():
    """The ten configs field for field (and their smoke configs), the
    shape cells, and ``input_specs``' shapes and dtypes on ``meta``."""
    from repro.configs import ALL_ARCHS as REF_ARCHS
    from repro.configs import SHAPES as REF_SHAPES
    from repro.models import input_specs as ref_input_specs

    assert ALL_ARCHS == REF_ARCHS and SHAPES == REF_SHAPES
    for arch in ALL_ARCHS:
        for full in (True, False):
            want = ref_get_config(arch)
            got = get_config(arch)
            if not full:
                want, got = ref_smoke_config(want), smoke_config(got)
            assert repr(got) == repr(want)
            assert got.param_count_dense() == want.param_count_dense()
    for arch in UNIFORM:
        cfg, ref_cfg = get_config(arch), ref_get_config(arch)
        for kind in ("train", "prefill", "decode"):
            want = jax.tree.leaves_with_path(
                ref_input_specs(ref_cfg, kind, 4096, 8))
            got = input_specs(cfg, kind, 4096, 8)
            flat = {**got.pop("cache", {}), **got}
            assert len(flat) == len(want)
            for path, spec in want:
                t = flat[path[-1].key]
                assert t.device.type == "meta"
                assert tuple(t.shape) == spec.shape
                assert str(t.dtype).split(".")[-1] == str(spec.dtype)


def test_params_from_numpy_keeps_bfloat16_bits():
    """The reference's default parameters are bfloat16 (numpy's
    ``ml_dtypes`` type): converted bit for bit, float32 norms stay
    float32, and the stacked layers land in their own modules."""
    ref_cfg = ref_smoke_config(ref_get_config("qwen2-7b"))
    tree = jax.tree.map(np.asarray,
                        ref_init_params(ref_cfg, jax.random.PRNGKey(0)))
    model = params_from_numpy(smoke_config(get_config("qwen2-7b")), tree,
                              device=CPU)
    assert len(model.layers) == ref_cfg.num_layers
    for i, layer in enumerate(model.layers):
        got, want = layer.attn.wq, tree["layers"]["attn"]["wq"][i]
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
        assert layer.ln1.dtype == torch.float32
    np.testing.assert_array_equal(model.embed.float().numpy(),
                                  tree["embed"].astype(np.float32))
