"""Serving the pattern families through the port's driver
(``repro_torch.launch.serve``), on the numpy weights of
tests/test_torch_lm_pattern.py, in float32.

xLSTM has no attention cache, so its greedy tokens must equal the
reference driver's.  Zamba2's are held to the teacher-forced argmax of
the reference's own ``forward`` instead: the reference driver grows no
cache of a pattern arch, so its shared attention's decode writes clamp
onto the last prompt position; the port grows every attention cache
along its sequence axis.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serve import serve as ref_serve
from repro.models import forward as ref_forward
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.serve import main, prefill, serve
from repro_torch.models.convert import params_from_numpy
from test_torch_lm_pattern import SLSTM, configs, numpy_tree

CPU = torch.device("cpu")


def both_models(arch: str, seed: int = 5, **options):
    ref_cfg, cfg = configs(arch, **options)
    tree = numpy_tree(ref_cfg, seed)
    return (ref_cfg, jax.tree.map(jnp.asarray, tree), cfg,
            params_from_numpy(cfg, tree, device=CPU))


def prompts(cfg, B: int, P: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, (B, P)).astype(np.int32)


@pytest.mark.parametrize("options", [{}, SLSTM], ids=["mlstm", "slstm"])
def test_xlstm_serve_matches_reference(options):
    """4 requests x 8 prompt tokens x 8 generated, token for token."""
    ref_cfg, ref_params, cfg, model = both_models("xlstm-350m", **options)
    p = prompts(cfg, 4, 8)
    want, _ = ref_serve(ref_cfg, ref_params, p, 8)
    got, stats = serve(cfg, model, p, 8, device=CPU)
    assert got.dtype == np.int32 and got.shape == (4, 8)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert stats.tokens == 32


@pytest.mark.parametrize("options", [{}, {"num_layers": 8},
                                     {"aes_kv_width": 8}],
                         ids=["zamba2", "zamba2-tail", "zamba2-aes8"])
def test_zamba2_serve_matches_teacher_forced_argmax(options):
    """Each generated token is the argmax of the reference's ``forward``
    over the prompt and the tokens before it (with AES-KV at W = 8 of 12
    positions the decode steps read a sample, so only the prefill's token
    is held; tests/test_torch_lm_pattern.py holds AES-KV's decode steps
    to the reference's); the prefill cache's K/V grow to S_max, states
    and conv caches keep their shapes."""
    ref_cfg, ref_params, cfg, model = both_models("zamba2-7b", **options)
    p = prompts(cfg, 2, 8)
    got, _ = serve(cfg, model, p, 4, device=CPU)
    seq = np.concatenate([p, got[:, :-1]], axis=1)
    logits, _, _ = ref_forward(ref_params, ref_cfg, tokens=jnp.asarray(seq),
                               remat=False)
    want = np.asarray(jnp.argmax(logits[:, 7:], axis=-1))
    n = 1 if cfg.aes_kv_width else 4
    np.testing.assert_array_equal(got[:, :n], want[:, :n])
    _, cache = prefill(cfg, model, torch.from_numpy(p), 12)
    assert cache["groups"]["k"].shape[2] == cache["groups"]["v"].shape[2] \
        == 12
    assert cache["groups"]["mamba"]["state"].shape[:2] == \
        (len(model.groups), len(model.groups[0].mamba))


def test_pattern_shared_attn_cache_grows():
    """A plain pattern's ``blocks[i].k``/``v`` grow along axis 1; served
    tokens equal the teacher-forced argmax."""
    ref_cfg, ref_params, cfg, model = both_models("zamba2-7b", attn_every=0)
    p = prompts(cfg, 2, 8)
    _, cache = prefill(cfg, model, torch.from_numpy(p), 12)
    kinds = cfg.block_pattern
    for kind, entry in zip(kinds, cache["blocks"]):
        if kind == "shared_attn":
            assert entry["k"].shape[1] == entry["v"].shape[1] == 12
        else:
            assert entry["state"].shape[0] == 2
    got, _ = serve(cfg, model, p, 4, device=CPU)
    seq = np.concatenate([p, got[:, :-1]], axis=1)
    logits, _, _ = ref_forward(ref_params, ref_cfg, tokens=jnp.asarray(seq),
                               remat=False)
    np.testing.assert_array_equal(
        got, np.asarray(jnp.argmax(logits[:, 7:], axis=-1)))


def test_kv_int8_on_a_pattern_arch_raises():
    """The pattern caches have no int8 layout: a ``ValueError`` that says
    so, from ``serve`` and from the command line (the reference serves
    bfloat16 without saying so)."""
    for arch in ("zamba2-7b", "xlstm-350m"):
        cfg = smoke_config(get_config(arch)).with_options(kv_quant_bits=8)
        with pytest.raises(ValueError, match="no int8 layout"):
            serve(cfg, None, prompts(cfg, 1, 4), 2, device=CPU)
        with pytest.raises(ValueError, match="no int8 layout"):
            main(["--arch", arch, "--smoke", "--kv-int8", "--device", "cpu"])


def test_serve_cli_runs_the_pattern_archs():
    """``python -m repro_torch.launch.serve --arch zamba2-7b --smoke
    --device cpu`` and xLSTM's, at their smoke configs' bfloat16."""
    for arch in ("zamba2-7b", "xlstm-350m"):
        stats = main(["--arch", arch, "--smoke", "--requests", "2",
                      "--prompt-len", "16", "--gen", "4", "--device", "cpu"])
        assert stats.tokens == 8
    stats = main(["--arch", "zamba2-7b", "--smoke", "--requests", "2",
                  "--prompt-len", "16", "--gen", "4", "--aes-kv", "8",
                  "--device", "cpu"])
    assert stats.tokens == 8
