"""The port's dequantization with per-segment constants: ``ops.dequantize``
and ``kernels.dequant.dequantize_plain`` given two ``[S]`` tables, ``q``'s
rows split into ``S`` equal segments, segment ``s`` through ``(scale[s],
x_min[s])``; and the spmd server's one call over its uint8 stack.

Held on the CPU (the wrapper runs the plain version for CPU tensors):
  * against itself: a segmented call equals one call a segment, and the
    wrapper equals the plain version, bit for bit (``torch.equal``);
  * against the JAX package's Eq. 2, segment by segment, each segment
    quantized with its own range as a shard is: the eager
    ``repro.kernels.dequant.dequant_epilogue`` bit for bit (it rounds after
    the product and after the sum, as the port does); the Pallas kernel
    (``repro.kernels.ops.dequantize``, interpret mode on the CPU) within
    half an ulp of the product ``q * scale`` plus one ulp of the result,
    since XLA contracts ``q * scale + x_min`` into one FMA, which skips the
    product's rounding; ``repro.kernels.ref.dequantize`` within that plus
    ``q`` ulps of ``scale``, since it computes ``scale`` under ``jit``,
    where XLA may turn the division by ``2**bits - 1`` into a product with
    its reciprocal (near a cancellation, ``q * scale`` close to
    ``-x_min``, the result's own ulp is far smaller than these bounds);
  * the spmd server's ``[num_shards]`` tables, one ``ops.dequantize`` call
    a pass over the whole stack, equal to a call a shard.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core.quantization import quantize as jquantize
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.dequant import dequant_epilogue
import repro_torch.core.graph as tg
from repro_torch.kernels import dequant as dequant_mod
from repro_torch.kernels import ops
from repro_torch.serving import GNNServer
from repro_torch.tuning import MachineModel, PlanCache

from conftest import random_csr

CPU = "cpu"
_DTYPES = {8: torch.uint8, 16: torch.uint16}
# (rows, features, segments): segment lengths that are and are not whole
# 16-element vectors, one segment, an empty matrix
CASES = [(12, 128, 1), (12, 128, 3), (12, 128, 4), (36, 7, 3), (44, 33, 4),
         (30, 1, 5), (0, 16, 4)]


def _q(rng, rows, feat, bits):
    q = rng.integers(0, 2 ** bits, size=(rows, feat)).astype(np.int64)
    return torch.from_numpy(q).to(_DTYPES[bits])


def _tables(rng, segs):
    scale = torch.from_numpy(rng.uniform(0.01, 2.0, segs).astype(np.float32))
    x_min = torch.from_numpy(rng.normal(size=segs).astype(np.float32) * 3)
    return scale, x_min


@pytest.mark.parametrize("rows,feat,segs", CASES)
@pytest.mark.parametrize("bits", [8, 16])
def test_segmented_equals_a_call_a_segment(rows, feat, segs, bits):
    rng = np.random.default_rng(rows * 31 + feat + segs + bits)
    q = _q(rng, rows, feat, bits)
    scale, x_min = _tables(rng, segs)
    got = dequant_mod.dequantize_plain(q, scale, x_min)
    n = rows // segs
    want = torch.cat([dequant_mod.dequantize_plain(
        q[s * n:(s + 1) * n], scale[s], x_min[s]) for s in range(segs)])
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.equal(got, want)
    # floats and 0-d tensors for one segment, as before
    for s in range(segs):
        assert torch.equal(want[s * n:(s + 1) * n],
                           dequant_mod.dequantize_plain(
                               q[s * n:(s + 1) * n], float(scale[s]),
                               float(x_min[s])))
    # the wrapper's CPU route, new and into a slice of a larger stack
    assert torch.equal(ops.dequantize(q, scale, x_min, bits=bits), want)
    big = torch.full((rows + 2, feat), float("nan"))
    out = ops.dequantize(q, scale, x_min, bits=bits, out=big[1:-1])
    assert out.data_ptr() == big[1:-1].data_ptr()
    assert torch.equal(big[1:-1], want)
    assert big[0].isnan().all() and big[-1].isnan().all()
    assert ops.launch_counts()["dequantize"] == 0


@pytest.mark.parametrize("bits", [8, 16])
def test_segments_match_the_reference_eq2(bits):
    """A stack of 3 segments of 20 x 33, each quantized with its own range
    (the reference's quantize, as a shard is), against the reference's Eq.
    2 applied to each segment alone."""
    rng = np.random.default_rng(bits)
    segs = [rng.normal(size=(20, 33)).astype(np.float32) * (s + 1) + s
            for s in range(3)]
    jqfs = [jquantize(x, bits) for x in segs]
    q = torch.cat([torch.from_numpy(np.asarray(j.q).astype(np.int64))
                   .to(_DTYPES[bits]) for j in jqfs])
    x_min = torch.tensor([float(j.x_min) for j in jqfs], dtype=torch.float32)
    x_max = torch.tensor([float(j.x_max) for j in jqfs], dtype=torch.float32)
    scale = (x_max - x_min) / (2 ** bits - 1)   # QuantizedFeatures.scale
    got = ops.dequantize(q, scale, x_min, bits=bits).numpy()
    assert np.array_equal(scale.numpy(), [np.float32(j.scale) for j in jqfs])
    for s, j in enumerate(jqfs):
        part = got[s * 20:(s + 1) * 20]
        assert np.array_equal(part, np.asarray(dequant_epilogue(
            j.q, j.scale, j.x_min)))
        levels = np.asarray(j.q).astype(np.float32)
        half_product = np.spacing(np.abs(levels * np.float32(j.scale))) / 2
        scale_ulps = levels * np.spacing(np.float32(j.scale))
        for want, bound in (
                (jops.dequantize(j.q, j.scale, j.x_min, bits=bits),
                 half_product),
                (jref.dequantize(j.q, j.x_min, j.x_max, bits),
                 half_product + scale_ulps)):
            want = np.asarray(want)
            assert (np.abs(part - want)
                    <= bound + np.spacing(np.abs(want))).all(), s


def test_refusals():
    q = torch.zeros((6, 4), dtype=torch.uint8)
    one, two = torch.ones(4), torch.zeros(4)
    for args, kw, match in (
            ((q, one, two), {}, "divides q's 6 rows"),       # 4 into 6 rows
            ((q, torch.ones(3), two), {}, "two scalars"),   # lengths differ
            ((q, torch.ones(3), 0.0), {}, "two scalars"),   # table + scalar
            ((q, torch.ones(2, 1), torch.ones(2, 1)), {}, "two scalars"),
            ((q, torch.ones(3).to("meta"), torch.ones(3)), {},
             "q's device"),
            ((q, torch.ones(3), torch.ones(3)), dict(bits=16),
             "does not match"),
            ((q.to(torch.uint16), torch.ones(3), torch.ones(3)), {},
             "does not match")):
        with pytest.raises(ValueError, match=match):
            dequant_mod.dequantize(*args, **kw)
    with pytest.raises(ValueError, match="divides"):
        dequant_mod.dequantize_plain(q, one, two)
    # [S] tables that divide the rows, and a [1] table as a scalar
    assert torch.equal(dequant_mod.dequantize(q, torch.ones(3),
                                              torch.ones(3)),
                       torch.ones((6, 4)))
    assert torch.equal(dequant_mod.dequantize(q, torch.ones(1), 2.0),
                       torch.full((6, 4), 2.0))


@pytest.mark.parametrize("shards,rows", [(1, 37), (3, 49), (4, 90)])
def test_spmd_stack_is_one_call_a_pass(monkeypatch, shards, rows):
    """The bundle keeps the shards' constants as ``[num_shards]`` tables on
    its device, and a resident pass makes one ``ops.dequantize`` call over
    the whole uint8 stack, equal to a call a shard."""
    rng = np.random.default_rng(rows)
    g = random_csr(rng, rows, 5.0, skew=0.8)
    x = rng.normal(size=(rows, 6)).astype(np.float32)
    csr = tg.CSR(*(torch.from_numpy(np.array(a)) for a in
                   (g.row_ptr, g.col_ind, g.val)), g.num_cols)
    spmd = GNNServer(csr, torch.from_numpy(x), num_shards=shards,
                     mode="spmd", quant=8, cache=PlanCache(), devices=[CPU],
                     tune_kwargs=dict(machine=MachineModel(), block_rows=8,
                                      widths=(2, 4, 8), measure_plan=False,
                                      measure_buckets=False))
    bundle = spmd._bundles[0]
    qs = [p.quantized for p in spmd.plans]
    assert bundle._scale.shape == bundle._x_min.shape == (shards,)
    assert torch.equal(bundle._scale, torch.stack([q.scale for q in qs]))
    assert torch.equal(bundle._x_min, torch.stack([q.x_min for q in qs]))
    calls = []
    real = ops.dequantize

    def spy(q, scale, x_min, **kw):
        calls.append((q.shape, scale.shape))
        return real(q, scale, x_min, **kw)

    monkeypatch.setattr(ops, "dequantize", spy)
    spmd.aggregate()
    g_rows = bundle.gcap
    assert calls == [(torch.Size([shards * g_rows, 6]),
                      torch.Size([shards]))]
    stack = dequant_mod.dequantize_plain(bundle._resident, bundle._scale,
                                         bundle._x_min)
    for s, q in enumerate(qs):
        assert torch.equal(stack[s * g_rows:(s + 1) * g_rows],
                           dequant_mod.dequantize_plain(
                               bundle._resident[s * g_rows:
                                                (s + 1) * g_rows],
                               q.scale, q.x_min))
