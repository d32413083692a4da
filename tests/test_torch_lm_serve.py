"""The port's serving driver (``repro_torch.launch.serve``) against the
reference's, on the same numpy weights (tests/test_torch_lm.py's
``numpy_tree``) and prompts.

Greedy tokens must be equal.  DeepSeek-V2 (MLA) is held to the teacher-
forced argmax of the reference's own ``forward`` instead: the reference
driver grows only caches whose axis -3 is the prompt length, which MLA's
``[L, B, S, C]`` latents are not, so its decode writes clamp onto the last
prompt position.  The port grows every cache along its sequence axis.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serve import serve as ref_serve
from repro.models import forward as ref_forward
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.serve import main, serve
from repro_torch.models import decode_step, forward, init_cache, init_params
from test_torch_lm import both_models

CPU = torch.device("cpu")


def prompts(cfg, B: int, P: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, (B, P)).astype(np.int32)


@pytest.mark.parametrize("arch,options", [
    ("qwen2-7b", {}),
    ("qwen2-7b", {"aes_kv_width": 8}),
    ("qwen2-7b", {"kv_quant_bits": 8}),
    ("qwen2-7b", {"aes_kv_width": 8, "kv_quant_bits": 8}),
    ("gemma-7b", {}),
    ("mixtral-8x22b", {}),
    ("mixtral-8x22b", {"aes_kv_width": 8, "kv_quant_bits": 8}),
], ids=["dense", "dense-aes8", "dense-int8", "dense-aes8-int8", "gemma",
        "swa-moe", "swa-moe-aes8-int8"])
def test_serve_tokens_match_reference(arch, options):
    """4 requests x 8 prompt tokens x 8 generated: dense with the paper's
    levers alone and together, Gemma (tied head, GeGLU), and Mixtral,
    whose 16-position cache (S_max = 16 <= its smoke window) is the SWA
    ring, through MoE layers."""
    ref_cfg, ref_params, cfg, model = both_models(arch, seed=5, **options)
    p = prompts(cfg, 4, 8)
    want, want_stats = ref_serve(ref_cfg, ref_params, p, 8)
    got, stats = serve(cfg, model, p, 8, device=CPU)
    assert got.dtype == np.int32 and got.shape == (4, 8)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats.tokens == want_stats.tokens == 32
    assert stats.prefill_s > 0 and stats.decode_s > 0


def test_deepseek_serve_matches_teacher_forced_argmax():
    """MLA's latent cache grows to S_max, so each generated token is the
    argmax of the reference's ``forward`` over the prompt and the tokens
    before it."""
    ref_cfg, ref_params, cfg, model = both_models("deepseek-v2-236b")
    p = prompts(cfg, 2, 8)
    got, _ = serve(cfg, model, p, 4, device=CPU)
    seq = np.concatenate([p, got[:, :-1]], axis=1)
    logits, _, _ = ref_forward(ref_params, ref_cfg,
                               tokens=jnp.asarray(seq), remat=False)
    want = np.asarray(jnp.argmax(logits[:, 7:], axis=-1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["xlstm-350m", "zamba2-7b"])
def test_pattern_families_raise_not_implemented(arch):
    """The pattern families, which every entry point once refused with
    ``NotImplementedError``, now run through each of them: ``init_params``,
    ``init_cache``, ``forward``, ``decode_step``, ``serve`` and the
    command line (tests/test_torch_lm_pattern.py holds them to the
    reference)."""
    cfg = smoke_config(get_config(arch))
    model = init_params(cfg, device=CPU)
    cache = init_cache(cfg, 1, 4, device=CPU)
    logits, _, _ = forward(model, cfg, tokens=torch.zeros(1, 4,
                                                          dtype=torch.int32))
    assert logits.shape == (1, 4, cfg.vocab_size)
    logits, _ = decode_step(model, cfg, cache,
                            tokens=torch.zeros(1, 1, dtype=torch.int32),
                            cache_len=0)
    assert torch.isfinite(logits).all()
    gen, _ = serve(cfg, model, prompts(cfg, 1, 4), 2, device=CPU)
    assert gen.shape == (1, 2)
    assert main(["--arch", arch, "--smoke", "--requests", "1",
                 "--prompt-len", "4", "--gen", "2",
                 "--device", "cpu"]).tokens == 2


def test_refusals():
    """MLA with the int8 cache is a clear ``ValueError`` (the reference
    raises ``KeyError: 'k'``); frontend stubs are refused by the driver as
    in the reference."""
    cfg = smoke_config(get_config("deepseek-v2-236b"))
    model = init_params(cfg, device=CPU)
    with pytest.raises(ValueError, match="int8"):
        serve(cfg.with_options(kv_quant_bits=8), model, prompts(cfg, 1, 4),
              2, device=CPU)
    with pytest.raises(ValueError, match="int8"):
        main(["--arch", "deepseek-v2-236b", "--smoke", "--kv-int8",
              "--device", "cpu"])
    for arch in ("pixtral-12b", "musicgen-large"):
        with pytest.raises(SystemExit, match="token archs"):
            main(["--arch", arch, "--smoke", "--device", "cpu"])


def test_serve_launcher_with_paper_levers():
    """The driver runs with AES-KV and the int8 KV cache together
    (tests/test_substrate.py's launcher test, on the CPU)."""
    stats = main(["--arch", "qwen1.5-0.5b", "--smoke", "--requests", "2",
                  "--prompt-len", "16", "--gen", "6", "--aes-kv", "8",
                  "--kv-int8", "--device", "cpu"])
    assert stats.tokens == 12


def test_aes_kv_example():
    from repro_torch.examples import aes_kv_serving

    agreement = aes_kv_serving.main(["--device", "cpu"])
    assert set(agreement) == {32, 16}
    assert all(0.0 <= a <= 1.0 for a in agreement.values())
