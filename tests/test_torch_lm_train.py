"""LM training in the port (``repro_torch.models.loss_fn``, remat and
``repro_torch.launch.train``'s step) against the reference's, on the
numpy weights of tests/test_torch_lm_pattern.py in float32.

Tolerances: the loss to 1e-5 relative (float32 cross entropy over 512
logits); every parameter's gradient to 1e-4 of its own largest magnitude
(float32, products and sums in another order; the largest seen is 3e-5,
on Zamba2's Mamba blocks, whose chunked scan compounds the most).
Gradients under the remat policies are bit-equal on the CPU: the
recomputation repeats the same operations.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import loss_fn as ref_loss_fn
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.train import make_train_step, value_and_grad
from repro_torch.models import lm, loss_fn
from repro_torch.models.convert import params_from_numpy
from repro_torch.optim import adamw_init, constant
from test_torch_lm_pattern import SLSTM, configs, numpy_tree

CPU = torch.device("cpu")
GRAD_TOL = 1e-4

#: dense, MoE (with Mixtral's sliding window), MLA (with MoE), xLSTM with
#: an sLSTM block, Zamba2 with a tail
ARCHS = [("tinyllama-1.1b", {}), ("mixtral-8x22b", {}),
         ("deepseek-v2-236b", {}), ("xlstm-350m", SLSTM),
         ("zamba2-7b", {"num_layers": 8})]
ARCH_IDS = ["dense", "moe", "mla", "xlstm", "zamba2"]


def batch(cfg, B: int = 2, S: int = 16, seed: int = 1) -> dict:
    """Next-token labels, the last position masked (-1)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": tokens, "labels": labels}


def params_of(model) -> dict:
    return {k: p.detach() for k, p in model.named_parameters()}


@pytest.mark.parametrize("arch,options", ARCHS, ids=ARCH_IDS)
def test_loss_and_grads_match_reference(arch, options):
    """``value_and_grad`` (``loss_fn`` through ``functional_call``, remat
    on) against ``jax.value_and_grad`` of the reference's ``loss_fn``:
    the loss, and each parameter's gradient by name."""
    ref_cfg, cfg = configs(arch, **options)
    tree = numpy_tree(ref_cfg, 0)
    model = params_from_numpy(cfg, tree, device=CPU)
    b = batch(cfg)
    want, ref_grads = jax.value_and_grad(
        lambda p: ref_loss_fn(p, ref_cfg,
                              {k: jnp.asarray(v) for k, v in b.items()}))(
        jax.tree.map(jnp.asarray, tree))
    loss, grads = value_and_grad(model, cfg, params_of(model),
                                 {k: torch.from_numpy(v)
                                  for k, v in b.items()})
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    want_grads = params_of(params_from_numpy(
        cfg, jax.tree.map(np.asarray, ref_grads), device=CPU))
    assert set(grads) == set(want_grads)
    for name, g in grads.items():
        w = want_grads[name]
        scale = float(w.abs().max())
        assert scale > 0, name
        torch.testing.assert_close(g, w, rtol=0, atol=GRAD_TOL * scale,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.parametrize("arch,options", [ARCHS[0], ARCHS[1], ARCHS[4]],
                         ids=["dense", "moe", "zamba2"])
def test_remat_policies_give_equal_grads(arch, options, monkeypatch):
    """The default policy (full recompute), ``"dots"`` (matmul outputs
    saved) and ``"nothing"``, and plain autograd on the module, give
    bit-equal losses and gradients; under the two checkpointing policies
    each uniform layer or group runs again in the backward pass."""
    _, cfg = configs(arch, **options)
    model = params_from_numpy(cfg, numpy_tree(configs(arch, **options)[0],
                                              0), device=CPU)
    b = {k: torch.from_numpy(v) for k, v in batch(cfg).items()}
    name = "_uniform_layer" if cfg.block_pattern is None else "_group"
    body, calls = getattr(lm, name), []

    def counted(*args, **kwargs):
        calls.append(1)
        return body(*args, **kwargs)

    monkeypatch.setattr(lm, name, counted)
    n_units = len(model.layers if cfg.block_pattern is None
                  else model.groups)
    results = {}
    for policy in (None, "dots", "nothing"):
        calls.clear()
        results[policy] = value_and_grad(
            model, cfg.with_options(remat_policy=policy), params_of(model),
            b)
        assert len(calls) == (n_units if policy == "nothing"
                              else 2 * n_units), policy
    for policy in ("dots", "nothing"):
        assert torch.equal(results[policy][0], results[None][0])
        for k, g in results[None][1].items():
            assert torch.equal(results[policy][1][k], g), (policy, k)
    for p in model.parameters():
        p.requires_grad_(True)
    loss_fn(model, cfg.with_options(remat_policy="nothing"), b).backward()
    for k, p in model.named_parameters():
        assert torch.equal(p.grad, results[None][1][k]), k


def test_value_and_grad_uses_the_given_params():
    """Through ``functional_call`` the loss and the recomputed layers read
    the given parameters, not the module's own: equal to plain autograd
    on a module that holds them."""
    _, cfg = configs("qwen2-7b")
    host = lm.init_params(cfg, 0, device=CPU)
    other = lm.init_params(cfg, 1, device=CPU)
    b = {k: torch.from_numpy(v) for k, v in batch(cfg).items()}
    loss, grads = value_and_grad(host, cfg, params_of(other), b)
    for p in other.parameters():
        p.requires_grad_(True)
    want = loss_fn(other, cfg.with_options(remat_policy="nothing"), b)
    want.backward()
    assert torch.equal(loss, want.detach())
    for k, p in other.named_parameters():
        assert torch.equal(grads[k], p.grad), k


@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x22b",
                                  "deepseek-v2-236b", "xlstm-350m",
                                  "zamba2-7b"])
def test_smoke_train_step_reduces_loss(arch):
    """tests/test_archs.py's claim on the port: 5 AdamW steps (lr 3e-3,
    here through ``make_train_step``, weight decay 0.1) on a constant
    batch of the bfloat16 smoke config lower the loss."""
    cfg = smoke_config(get_config(arch))
    model = lm.init_params(cfg, 0, device=CPU)
    b = {"tokens": torch.ones((2, 16), dtype=torch.int32),
         "labels": torch.ones((2, 16), dtype=torch.int32)}
    step = make_train_step(cfg, model, constant(3e-3))
    params = params_of(model)
    state = (params, adamw_init(params))
    losses = []
    for _ in range(5):
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert int(state[1].step) == 5
    assert all(p.dtype == q.dtype for p, q in zip(state[0].values(),
                                                  params.values()))
