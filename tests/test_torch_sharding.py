"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's, for all ten architectures at full size on both production
meshes: the port's shapes from ``FakeTensorMode`` (no storage), the
reference's from ``jax.eval_shape``, both meshes abstract.

Every parameter spec is the reference's spec of the stacked tensor with the
stacked leading axes dropped; every AdamW spec likewise, with ZeRO-1 off and
on, except the musicgen-large ZeRO-1 leaves listed below; cache and batch
specs are equal whole; every cell's per-device argument bytes equal the
reference's sum of shard bytes (which is XLA's ``argument_size_in_bytes``).
The archs are looped over inside each test.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ALL_ARCHS, SHAPES, get_config as ref_config
from repro.distributed import sharding as ref
from repro.distributed.mesh_compat import abstract_mesh as ref_mesh
from repro.models import init_cache as ref_cache
from repro.models import init_params as ref_init
from repro.models import input_specs as ref_specs
from repro.optim import adamw_init as ref_adamw
from repro_torch.configs import get_config
from repro_torch.distributed import sharding
from repro_torch.distributed.mesh_compat import abstract_mesh
from repro_torch.launch.dryrun import argument_bytes, build_cell
from repro_torch.models import init_cache, init_params, input_specs
from repro_torch.optim import adamw_init

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
#: musicgen-large on 16x16: its 48 layers divide the 16 DP ranks, so the
#: reference's ZeRO-1 shards the stacked layer axis of these moments; the
#: port, with no stacked axis, takes the first replicated dim of the
#: per-layer tensor that divides 16 (or none)
MUSICGEN_ZERO1_LEAVES = {
    "layers/attn/wq", "layers/attn/wk", "layers/attn/wv", "layers/attn/wo",
    "layers/ln1", "layers/ln2", "layers/mlp/w_gate", "layers/mlp/w_up",
    "layers/mlp/w_down"}
#: TinyLlama-1.1B train_4k on 16x16: params + AdamW + batch, one device
#: (the reference's sum of shard bytes, equal to XLA's argument size)
TINYLLAMA_TRAIN_4K_BYTES = 905_371_652


def _norm(spec, ndim: int) -> tuple:
    """A spec as one tuple of axis names per dim (() replicated)."""
    spec = tuple(spec) + (None,) * (ndim - len(tuple(spec)))
    return tuple(() if e is None else ((e,) if isinstance(e, str)
                                       else tuple(e)) for e in spec)


def _ref_leaves(tree, shardings) -> dict:
    """'/'-joined reference path -> (shape, normalized spec)."""
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    shards = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    return {"/".join(ref._path_names(path)): (tuple(leaf.shape),
                                              _norm(sh.spec, leaf.ndim))
            for (path, leaf), sh in zip(leaves, shards)}


#: one fake mode for every fake tensor of this file
FAKE = FakeTensorMode()


@pytest.fixture(scope="module")
def models():
    """arch -> (reference params' shapes, the port's parameters, fake)."""
    out = {}
    with FAKE:
        for arch in ALL_ARCHS:
            rp = jax.eval_shape(functools.partial(ref_init, ref_config(arch)),
                                jax.random.PRNGKey(0))
            model = init_params(get_config(arch), 0, device="cpu")
            out[arch] = (rp, {k: p.detach()
                              for k, p in model.named_parameters()})
    return out


def _meshes():
    for name, (sizes, axes) in MESHES.items():
        yield name, ref_mesh(sizes, axes), abstract_mesh(sizes, axes)


def test_reference_names_and_placements():
    assert sharding.reference_names("layers.3.attn.wq") == [
        "layers", "attn", "wq"]
    assert sharding.reference_names("groups.1.mamba.2.w_x") == [
        "groups", "mamba", "w_x"]
    assert sharding.reference_names("tail.mamba.0.w_x") == [
        "tail", "mamba", "w_x"]
    assert sharding.reference_names("blocks.5.w_up") == [
        "blocks", "[5]", "w_up"]
    assert sharding.reference_names("block_norms.5") == [
        "block_norms", "[5]"]
    with pytest.raises(ValueError, match="equal length"):
        abstract_mesh((16, 16), ("data",))
    from torch.distributed.tensor import Replicate, Shard

    mp = abstract_mesh(*MESHES["2x16x16"])
    assert sharding.to_placements(((("pod", "data")), None, "model"), mp) \
        == [Shard(0), Shard(0), Shard(2)]
    assert sharding.to_placements((None, None), mp) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        sharding.to_placements((("data", "pod"),), mp)


def test_param_specs_equal_the_reference(models):
    for mesh_name, rmesh, mesh in _meshes():
        for arch in ALL_ARCHS:
            rp, params = models[arch]
            want = _ref_leaves(rp, ref.param_shardings(rmesh, rp))
            got = sharding.param_shardings(mesh, params)
            seen = set()
            for name, p in params.items():
                key = "/".join(sharding.reference_names(name))
                seen.add(key)
                shape, spec = want[key]
                lead = len(shape) - p.ndim
                assert shape[lead:] == tuple(p.shape), (arch, name)
                assert spec[:lead] == ((),) * lead, (arch, name)
                assert _norm(got[name], p.ndim) == spec[lead:], (
                    mesh_name, arch, name, got[name], spec)
            assert seen == set(want), (arch, set(want) - seen)


def test_adamw_specs_equal_the_reference_zero1_off_and_on(models):
    for mesh_name, rmesh, mesh in _meshes():
        for arch in ALL_ARCHS:
            rp, params = models[arch]
            ropt = jax.eval_shape(ref_adamw, rp)
            with FAKE:
                opt = adamw_init(params)
            stacked_dp = set()
            for zero1 in (False, True):
                want = _ref_leaves(ropt, ref.opt_shardings(rmesh, ropt,
                                                           zero1=zero1))
                got = sharding.opt_shardings(mesh, opt, zero1=zero1)
                assert got.step == () and want["step"][1] == ()
                for moment in ("mu", "nu"):
                    for name, t in getattr(opt, moment).items():
                        key = "/".join(sharding.reference_names(name))
                        shape, spec = want[f"{moment}/{key}"]
                        lead = len(shape) - t.ndim
                        spec_got = _norm(getattr(got, moment)[name], t.ndim)
                        if spec[:lead] != ((),) * lead:
                            # ZeRO-1 on a stacked axis: the port's rule
                            stacked_dp.add(key)
                            dp = sharding.dp_axes(mesh)
                            base = _norm(sharding.param_spec(
                                name, t.shape, mesh), t.ndim)
                            first = next((i for i, (e, d) in enumerate(
                                zip(base, t.shape)) if e == () and
                                d % sharding.axes_size(mesh, dp) == 0), None)
                            if first is not None:
                                base = (base[:first] + (dp,)
                                        + base[first + 1:])
                            assert zero1 and spec_got == base, (name,)
                        else:
                            assert spec_got == spec[lead:], (
                                mesh_name, arch, zero1, moment, name)
            expect = (MUSICGEN_ZERO1_LEAVES if (arch, mesh_name) == (
                "musicgen-large", "16x16") else set())
            assert stacked_dp == expect, (arch, mesh_name, stacked_dp)


def test_cache_specs_equal_the_reference():
    for mesh_name, rmesh, mesh in _meshes():
        for arch in ALL_ARCHS:
            rcfg, cfg = ref_config(arch), get_config(arch)
            for shape in ("decode_32k", "long_500k"):
                seq, batch, _ = SHAPES[shape]
                if shape == "long_500k" and not cfg.sub_quadratic:
                    continue
                rc = jax.eval_shape(lambda: ref_cache(rcfg, batch, seq))
                want = _ref_leaves(rc, ref.cache_shardings(
                    rmesh, rc, stacked=rcfg.block_pattern is None))
                with FAKE:
                    cache = init_cache(cfg, batch, seq, device="cpu")
                keys = sharding._map_named(lambda names, leaf: "/".join(names),
                                           cache)
                got = {}
                sharding.zip_map(
                    lambda key, pair: got.__setitem__(key, pair), keys,
                    sharding.zip_map(lambda t, spec: (tuple(t.shape),
                                                      _norm(spec, t.ndim)),
                                     cache, sharding.cache_shardings(
                                         mesh, cache,
                                         stacked=cfg.block_pattern is None)))
                assert set(got) == set(want), (arch, shape)
                for key, pair in got.items():
                    assert want[key] == pair, (mesh_name, arch, shape, key)


def test_batch_specs_equal_the_reference_on_2x16x16():
    rmesh = ref_mesh(*MESHES["2x16x16"])
    mesh = abstract_mesh(*MESHES["2x16x16"])
    for arch in ALL_ARCHS:
        for kind, shape in (("train", "train_4k"), ("prefill", "prefill_32k")):
            seq, batch, _ = SHAPES[shape]
            rs = ref_specs(ref_config(arch), kind, seq, batch)
            want = _ref_leaves(rs, ref.batch_shardings(rmesh, rs))
            specs = input_specs(get_config(arch), kind, seq, batch)
            got = sharding.batch_shardings(mesh, specs)
            assert {k: (tuple(v.shape), _norm(got[k], v.ndim))
                    for k, v in specs.items()} == want, (arch, kind)


def _ref_argument_bytes(arch: str, shape: str, rmesh) -> int:
    cfg = ref_config(arch)
    seq, batch, kind = SHAPES[shape]
    rp = jax.eval_shape(functools.partial(ref_init, cfg),
                        jax.random.PRNGKey(0))
    trees = [(rp, ref.param_shardings(rmesh, rp))]
    specs = ref_specs(cfg, kind, seq, batch)
    if kind == "train":
        ropt = jax.eval_shape(ref_adamw, rp)
        trees.append((ropt, ref.opt_shardings(rmesh, ropt)))
    if kind == "decode":
        cache = specs.pop("cache")
        trees.append((cache, ref.cache_shardings(
            rmesh, cache, stacked=cfg.block_pattern is None)))
        trees.append((specs.pop("cache_len"), ref.scalar_sharding(rmesh)))
    trees.append((specs, ref.batch_shardings(rmesh, specs)))
    total = 0
    for tree, shardings in trees:
        leaves = jax.tree.leaves(tree)
        shards = jax.tree.leaves(shardings,
                                 is_leaf=lambda x: hasattr(x, "spec"))
        for leaf, sh in zip(leaves, shards):
            total += (int(np.prod(sh.shard_shape(leaf.shape)))
                      * leaf.dtype.itemsize)
    return total


def test_every_cells_argument_bytes_equal_the_reference():
    for mesh_name, rmesh, mesh in _meshes():
        for arch in ALL_ARCHS:
            for shape in SHAPES:
                if shape == "long_500k" and not get_config(arch).sub_quadratic:
                    continue
                with FAKE:
                    _, args, specs = build_cell(arch, shape, mesh,
                                                device="cpu")
                    got = argument_bytes(args, specs, mesh)
                want = _ref_argument_bytes(arch, shape, rmesh)
                assert got == want, (mesh_name, arch, shape, got, want)
                if (arch, shape, mesh_name) == ("tinyllama-1.1b", "train_4k",
                                                "16x16"):
                    assert got == TINYLLAMA_TRAIN_4K_BYTES
