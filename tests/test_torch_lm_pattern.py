"""The port's pattern families (``repro_torch.models.ssm``, ``.xlstm`` and
the grouped and pattern branches of ``.lm``) against the reference's, in
float32 on the same numpy weights (carried across by
``params_from_numpy``).

Tolerances: blocks and ``forward``'s logits to 1e-4 (float32 throughout;
the chunked products sum in another order, and the port writes the
reference's three- and four-operand einsums as broadcasts and one
product).  Decode reads bfloat16 conv caches and, for the shared
attention, a bfloat16 K/V cache: each ``decode_step``'s logits to 2e-3,
the reference's decode-vs-prefill tolerance, each step from the
reference's cache (tests/test_torch_lm.py).  Caches: float32 states to
1e-4, bfloat16 entries to one bfloat16 step (``rtol=2**-7``), both with
an absolute 1e-4 of the entry's largest magnitude: the float32
agreement of the values they are cast from (a value near zero can be a
few bfloat16 steps apart).  Entries a ``decode_step`` writes after a
shared attention take its 2e-3 instead: that attention's output is
bfloat16, as in the reference, and one bfloat16 step there moves every
later block's input.
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
from repro.models import input_specs as ref_input_specs
from repro.models import ssm as ref_ssm
from repro.models import xlstm as ref_xlstm
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, input_specs)
from repro_torch.models import ssm, xlstm
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import ParamTree

CPU = torch.device("cpu")
TOL = 1e-4
DEC_TOL = 2e-3
CACHE_RTOL = 2.0 ** -7

#: (arch, config options): the two smoke configs (xLSTM's holds its
#: pattern's first 4 blocks, all mLSTM); xLSTM with an sLSTM block last;
#: Zamba2 at 8 layers,
#: whose ``attn_every`` of 3 leaves a tail of 2 Mamba blocks after 2
#: groups (the full Zamba2: 13 groups of 5, a tail of 3); Zamba2's blocks
#: as a plain pattern (``attn_every=0``), its ``shared_attn`` entries
#: applied block by block
SLSTM = {"block_pattern": ("mlstm", "mlstm", "mlstm", "slstm")}
CASES = [("xlstm-350m", {}), ("xlstm-350m", SLSTM), ("zamba2-7b", {}),
         ("zamba2-7b", {"num_layers": 8}), ("zamba2-7b", {"attn_every": 0})]
CASE_IDS = ["xlstm", "xlstm-slstm", "zamba2", "zamba2-tail",
            "zamba2-pattern"]
#: leading stacked axes of the reference's parameter tree, by top key
STACKED = {"layers": 1, "groups": 2, "tail": 1}


def configs(arch: str, **options):
    kw = dict(param_dtype="float32", **options)
    return (ref_smoke_config(ref_get_config(arch)).with_options(**kw),
            smoke_config(get_config(arch)).with_options(**kw))


def random_leaf(rng, name: str, shape, dtype, lead: int = 0):
    """Matrices at 1/sqrt(fan-in), vectors (gains, biases) and Mamba's
    conv taps at 0.1 (the reference's ``conv_x`` scale), in the
    reference's layout: the first ``lead`` axes are stacked layers."""
    core = shape[lead:]
    scale = (1.0 / np.sqrt(core[0]) if len(core) >= 2
             and not name.startswith("conv") else 0.1)
    return (rng.normal(size=shape) * scale).astype(np.dtype(dtype))


def numpy_tree(ref_cfg, seed: int) -> dict:
    shapes = jax.eval_shape(lambda: ref_init_params(ref_cfg,
                                                    jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: random_leaf(rng, getattr(path[-1], "key", ""),
                                       leaf.shape,
                                       leaf.dtype,
                                       STACKED.get(path[0].key, 0)),
        shapes)


def block_params(init, ref_cfg, seed: int, **override):
    """One block's numpy weights, as the reference's dict and the port's
    module."""
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), ref_cfg))
    rng = np.random.default_rng(seed)
    tree = {k: random_leaf(rng, k, s.shape, s.dtype)
            for k, s in shapes.items()}
    tree.update(override)
    return tree, ParamTree({k: torch.from_numpy(v) for k, v in tree.items()})


def to_torch(tree):
    """A reference cache (nested dicts and lists) as the port's tensors,
    bit for bit."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v) for v in tree]
    a = np.asarray(tree, np.float32 if tree.dtype == jnp.bfloat16 else None)
    t = torch.from_numpy(a.copy())
    return t.to(torch.bfloat16) if tree.dtype == jnp.bfloat16 else t


def assert_tree_close(got, want, path="", tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_close(got[k], want[k], f"{path}/{k}", tol)
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, f"{path}/{i}", tol)
        return
    assert tuple(got.shape) == want.shape, path
    assert str(got.dtype).split(".")[-1] == str(want.dtype), path
    want = np.asarray(want, np.float32)
    rtol = CACHE_RTOL if got.dtype == torch.bfloat16 else TOL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rtol,
                               atol=tol * max(1.0, np.abs(want).max()),
                               err_msg=path)


def grow_reference(cache, extra: int):
    """The reference's prefill cache with every K/V grown by ``extra``
    positions along its sequence axis (-3), as the port's serve does."""
    def grow(path, a):
        if path[-1].key not in ("k", "v"):
            return a
        pad = [(0, 0)] * a.ndim
        pad[-3] = (0, extra)
        return jnp.pad(a, pad)

    return jax.tree_util.tree_map_with_path(grow, cache)


def test_mamba_block_matches_reference():
    """Prefill over 4 chunks of 8, from zeros and from a random state (A
    near -0.1, so the state outlives a chunk), then 4 decode steps from
    the reference's state and conv caches."""
    ref_cfg, cfg = configs("zamba2-7b")
    rng = np.random.default_rng(2)
    H = cfg.num_heads
    tree, p = block_params(
        ref_ssm.init_mamba, ref_cfg, 0,
        A_log=(np.log(0.1) + 0.1 * rng.normal(size=H)).astype(np.float32))
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    state = rng.normal(size=(2, H, 2 * cfg.d_model // H, cfg.ssm_state)
                       ).astype(np.float32)
    outs = []
    for st in (None, state):
        want = ref_ssm.mamba_block(tree, jnp.asarray(x), ref_cfg,
                                   state=None if st is None
                                   else jnp.asarray(st), chunk=8)
        got = ssm.mamba_block(p, torch.from_numpy(x), cfg,
                              state=None if st is None
                              else torch.from_numpy(st), chunk=8)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=TOL, atol=TOL)
        assert_tree_close(got[1], want[1])
        assert_tree_close(got[2], want[2])
        outs.append(got[0])
    assert not torch.allclose(outs[0], outs[1], atol=1e-2)  # state counts

    ref_state, ref_conv = want[1], want[2]
    for _ in range(4):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        st, conv = to_torch(ref_state), to_torch(ref_conv)
        want_y, ref_state, ref_conv = ref_ssm.mamba_block(
            tree, jnp.asarray(xt), ref_cfg, state=ref_state,
            conv_cache=ref_conv)
        got_y, got_state, got_conv = ssm.mamba_block(
            p, torch.from_numpy(xt), cfg, state=st, conv_cache=conv)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   rtol=TOL, atol=TOL)
        assert_tree_close(got_state, ref_state)
        assert_tree_close(got_conv, ref_conv)
    with pytest.raises(ValueError, match="not divisible"):
        ssm.mamba_block(p, torch.from_numpy(x[:, :12]), cfg, chunk=8)


def test_mlstm_block_matches_reference():
    """Prefill over 4 chunks of 8 from zeros and from a random state, then
    4 decode steps, each from the reference's state."""
    ref_cfg, cfg = configs("xlstm-350m")
    rng = np.random.default_rng(3)
    tree, p = block_params(ref_xlstm.init_mlstm, ref_cfg, 1)
    hd = 2 * cfg.d_model // cfg.num_heads
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    state = rng.normal(size=(2, cfg.num_heads, hd, hd + 1)).astype(np.float32)
    for st in (None, state):
        want = ref_xlstm.mlstm_block(tree, jnp.asarray(x), ref_cfg,
                                     state=None if st is None
                                     else jnp.asarray(st), chunk=8)
        got = xlstm.mlstm_block(p, torch.from_numpy(x), cfg,
                                state=None if st is None
                                else torch.from_numpy(st), chunk=8)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   rtol=TOL, atol=TOL)
        assert_tree_close(got[1], want[1])
    ref_state = want[1]
    for _ in range(4):
        xt = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        st = to_torch(ref_state)
        want_y, ref_state = ref_xlstm.mlstm_block(tree, jnp.asarray(xt),
                                                  ref_cfg, state=ref_state)
        got_y, got_state = xlstm.mlstm_block(p, torch.from_numpy(xt), cfg,
                                             state=st)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   rtol=TOL, atol=TOL)
        assert_tree_close(got_state, ref_state)
    with pytest.raises(ValueError, match="not divisible"):
        xlstm.mlstm_block(p, torch.from_numpy(x[:, :12]), cfg, chunk=8)


def test_slstm_block_matches_reference():
    """The sequential loop over 24 positions from (0, 1, 0), then on from
    its final state for 3 positions and for 1 (the decode step)."""
    ref_cfg, cfg = configs("xlstm-350m")
    rng = np.random.default_rng(4)
    tree, p = block_params(ref_xlstm.init_slstm, ref_cfg, 2)
    ref_state, state = None, None
    for S in (24, 3, 1):
        x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
        want_y, ref_state = ref_xlstm.slstm_block(tree, jnp.asarray(x),
                                                  ref_cfg, state=ref_state)
        got_y, state = xlstm.slstm_block(p, torch.from_numpy(x), cfg,
                                         state=state)
        np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y),
                                   rtol=TOL, atol=TOL)
        assert_tree_close(list(state), list(ref_state))


@pytest.mark.parametrize("arch,options", CASES, ids=CASE_IDS)
def test_forward_and_decode_match_reference(arch, options):
    """Prefill logits and the prefill cache, then four decode steps from
    that cache (K/V grown by 8 positions) against the reference's, step
    by step; Zamba2 also with AES-KV at W = 8 of the shared attention's
    16 positions."""
    ref_cfg, cfg = configs(arch, **options)
    tree = numpy_tree(ref_cfg, 0)
    ref_params = jax.tree.map(jnp.asarray, tree)
    model = params_from_numpy(cfg, tree, device=CPU)
    rng = np.random.default_rng(1)
    B, S = 2, 8
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    want, _, want_cache = ref_forward(ref_params, ref_cfg,
                                      tokens=jnp.asarray(tokens),
                                      want_cache=True, remat=False)
    got, aux, got_cache = forward(model, cfg, tokens=torch.from_numpy(tokens),
                                  want_cache=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    assert float(aux) == 0.0
    assert_tree_close(got_cache, want_cache)

    grown = grow_reference(want_cache, 8)
    variants = [(ref_cfg, cfg)]
    if "shared_attn" in cfg.block_pattern:
        variants.append(configs(arch, aes_kv_width=8, **options))
    for ref_c, c in variants:
        ref_cache = grown
        for t in range(S, S + 4):
            step = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
            cache = to_torch(ref_cache)
            want, ref_cache = ref_decode_step(ref_params, ref_c, ref_cache,
                                              tokens=jnp.asarray(step),
                                              cache_len=jnp.int32(t))
            got, cache = decode_step(model, c, cache,
                                     tokens=torch.from_numpy(step),
                                     cache_len=t)
            assert got.shape == (B, 1, cfg.vocab_size)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=DEC_TOL, atol=DEC_TOL)
            assert_tree_close(cache, ref_cache, tol=DEC_TOL)


@pytest.mark.parametrize("arch,options", CASES, ids=CASE_IDS)
def test_init_cache_and_input_specs_match_reference(arch, options):
    """The empty cache's tree, names, shapes, dtypes and values (zeros,
    sLSTM's normalizer ones), and the decode specs of the full config on
    ``meta``."""
    ref_cfg, cfg = configs(arch, **options)
    assert_tree_close(init_cache(cfg, 2, 40, device=CPU),
                      ref_init_cache(ref_cfg, 2, 40))
    full, ref_full = get_config(arch), ref_get_config(arch)
    want = jax.tree_util.tree_flatten_with_path(
        ref_input_specs(ref_full, "decode", 4096, 8))[0]
    got = jax.tree_util.tree_flatten_with_path(
        input_specs(full, "decode", 4096, 8))[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (_, t), (_, spec) in zip(got, want):
        assert t.device.type == "meta"
        assert tuple(t.shape) == spec.shape
        assert str(t.dtype).split(".")[-1] == str(spec.dtype)


def test_params_from_numpy_layouts():
    """The grouped tree lands one module a Mamba block (``groups.g.mamba.j``
    from ``[G, per, ...]``, ``groups.g.norms`` from ``[G, per + 1, d]``,
    the tail), the pattern tree one a block, ``shared_attn`` entries
    empty; bfloat16 leaves bit for bit; and ``init_params`` draws the
    same names and shapes."""
    for arch, options in (("zamba2-7b", {"num_layers": 8}),
                          ("xlstm-350m", SLSTM)):
        ref_cfg = ref_smoke_config(ref_get_config(arch)).with_options(
            **options)
        cfg = smoke_config(get_config(arch)).with_options(**options)
        tree = jax.tree.map(np.asarray,
                            ref_init_params(ref_cfg, jax.random.PRNGKey(0)))
        model = params_from_numpy(cfg, tree, device=CPU)
        fresh = init_params(cfg, 0, device=CPU)
        assert sorted((n, p.shape, p.dtype)
                      for n, p in model.named_parameters()) == \
            sorted((n, p.shape, p.dtype) for n, p in fresh.named_parameters())
        if "groups" in tree:
            G, per = tree["groups"]["norms"].shape[:2]
            assert (len(model.groups), len(model.groups[0].mamba)) == \
                (G, per - 1)
            got = model.groups[1].mamba[1].w_z
            want = tree["groups"]["mamba"]["w_z"][1, 1]
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          want.view(np.int16))
            np.testing.assert_array_equal(model.groups[1].norms.numpy(),
                                          tree["groups"]["norms"][1])
            np.testing.assert_array_equal(
                model.tail.mamba[1].conv_x.float().numpy(),
                tree["tail"]["mamba"]["conv_x"][1].astype(np.float32))
        else:
            assert len(model.blocks) == len(cfg.block_pattern)
            got = model.blocks[3].r
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          tree["blocks"][3]["r"].view(
                                              np.int16))
            assert model.block_norms[0].dtype == torch.float32
    cfg = smoke_config(get_config("zamba2-7b")).with_options(attn_every=0)
    model = init_params(cfg, 0, device=CPU)
    assert list(model.blocks[2].parameters()) == []
    assert hasattr(model, "shared_attn") and hasattr(model, "shared_mlp")
