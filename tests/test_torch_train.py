"""The port's training against the JAX package's: the reference's AdamW,
the cross entropy, three epochs of ``train_model``, the presampled
aggregation and the paper's GNN configs; then the claims of
tests/test_gnn.py on the port's own training (same datasets and seeds),
and the two example modules on the CPU.

Tolerances: AdamW 1e-6 relative to each array's largest magnitude (the
global norm's sum and the bias corrections' ``b**t`` are the operations
whose rounding may differ: a 1-ulp change of the clip scale moves every
clipped gradient, and ``b1 * m + (1 - b1) * g`` cancels where the two
terms have opposite signs, so an element near zero can move by more than
1e-6 of itself);
the cross entropy 1e-6; the parameters after three epochs 1e-5, on the
dataset and widths tests/test_torch_gnn.py trains with (AdamW's update
``g / (|g| + eps)`` turns a gradient element that cancels to the order
of eps, 1e-8, into a step that the last bits of its sum move, so a wider
model on another graph can end further apart); the presampled
aggregation 1e-5.  Cases loop inside tests, so the file stays smaller
than the JAX package's test files (see tests/test_torch_core.py).
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.gnn_paper import PAPER_GNN_CONFIGS as JCONFIGS
from repro.gnn import make_dataset as jmake_dataset
from repro.gnn import train_model as jtrain_model
from repro.gnn.models import make_presampled_agg as jmake_presampled_agg
from repro.gnn.train import cross_entropy as jcross_entropy
from repro.optim import adamw as jadamw
from repro_torch.configs import PAPER_GNN_CONFIGS, GNNConfig
from repro_torch.gnn import (GCNParams, SAGEParams, cross_entropy, evaluate,
                             make_dataset, make_presampled_agg,
                             params_from_numpy, train_model)
from repro_torch.optim import (adamw_init, adamw_update, clip_by_global_norm,
                               global_norm)

# one intra-op thread: the suite runs in parallel workers beside timing tests
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CPU = "cpu"
DATA = dict(name="reddit", scale=0.001, seed=3, max_avg_degree=16.0)


def _t(tree) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _close(got: torch.Tensor, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


def _rel(got: torch.Tensor, want, rtol=1e-6, msg=""):
    """Within ``rtol`` of ``want``'s largest magnitude."""
    want = np.asarray(want)
    _close(got, want, 0.0, rtol * float(np.abs(want).max()), msg)


def test_adamw_matches_reference():
    """Three steps with clipping active, inactive and off, weight decay on
    and off; global_norm and clip_by_global_norm alone."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4)}
    for scale, max_norm, wd in ((10.0, 1.0, 5e-4), (1e-3, 1.0, 5e-4),
                                (10.0, None, 1e-2), (1.0, 1.0, 0.0)):
        params = {k: rng.normal(size=s).astype(np.float32)
                  for k, s in shapes.items()}
        jp, tp = dict(params), _t(params)
        jstate, tstate = jadamw.adamw_init(jp), adamw_init(tp)
        for _ in range(3):
            grads = {k: (rng.normal(size=s) * scale).astype(np.float32)
                     for k, s in shapes.items()}
            jnorm = float(jadamw.global_norm(grads))
            _rel(global_norm(_t(grads)), jnorm)
            if max_norm is not None:
                assert (jnorm > max_norm) == (scale >= 1.0)  # active or not
                jclip, _ = jadamw.clip_by_global_norm(grads, max_norm)
                tclip, _ = clip_by_global_norm(_t(grads), max_norm)
                for k in shapes:
                    _rel(tclip[k], jclip[k])
            jp, jstate = jadamw.adamw_update(
                grads, jstate, jp, lr=5e-3, weight_decay=wd,
                max_grad_norm=max_norm)
            tp, tstate = adamw_update(_t(grads), tstate, tp, lr=5e-3,
                                      weight_decay=wd,
                                      max_grad_norm=max_norm)
            assert tstate.step.dtype == torch.int32
            assert int(tstate.step) == int(jstate.step)
            for k in shapes:
                msg = f"{k} scale={scale} clip={max_norm} wd={wd}"
                _rel(tp[k], jp[k], msg=msg)
                _rel(tstate.mu[k], jstate.mu[k], msg=msg)
                _rel(tstate.nu[k], jstate.nu[k], msg=msg)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(50, 7)) * 4).astype(np.float32)
    labels = rng.integers(0, 7, 50).astype(np.int32)
    for mask in (rng.random(50) < 0.3, np.zeros(50, bool), np.ones(50, bool)):
        want = jcross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                              jnp.asarray(mask, jnp.float32))
        got = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels), torch.from_numpy(mask))
        _close(got, want, 1e-6, 1e-6)


def test_train_model_three_epochs_matches_reference():
    """Every parameter after three epochs, both models (the initial draws,
    the exact aggregation's gradients and three AdamW steps)."""
    jds = jmake_dataset(**DATA)
    ds = make_dataset(**DATA, device=CPU)
    for model, fields in (("gcn", GCNParams._fields),
                          ("graphsage", SAGEParams._fields)):
        for seed in (0, 1):
            want, _ = jtrain_model(jds, model, hidden=16, epochs=3, seed=seed)
            got, _ = train_model(ds, model, hidden=16, epochs=3, seed=seed,
                                 device=CPU)
            assert tuple(want._fields) == fields
            for k, v in want._asdict().items():
                p = getattr(got, k)
                assert not p.requires_grad
                _close(p, v, 0.0, 1e-5, msg=f"{model} seed={seed} {k}")


def test_presampled_agg_matches_reference():
    """``backend="torch"`` against the reference's ``"jax"``, and
    ``"cuda"`` (the kernels' plain versions on CPU tensors) against
    ``"torch"``, for the three strategies, on two calls of one agg."""
    jds = jmake_dataset(**DATA)
    ds = make_dataset(**DATA, device=CPU)
    x = np.random.default_rng(2).normal(
        size=(ds.csr.num_rows, 12)).astype(np.float32)
    for strategy in ("aes", "afs", "sfs"):
        for W in (4, 16):
            jagg = jmake_presampled_agg(jds.gcn_adj, W, strategy)
            want = np.asarray(jagg(jds.gcn_adj, jnp.asarray(x)))
            tagg = make_presampled_agg(ds.gcn_adj, W, strategy, device=CPU)
            cagg = make_presampled_agg(ds.gcn_adj, W, strategy, "cuda",
                                       device=CPU)
            for _ in range(2):
                got = tagg(ds.gcn_adj, torch.from_numpy(x))
                _close(got, want, 1e-5, 1e-5, msg=f"{strategy} W={W}")
                _close(cagg(None, torch.from_numpy(x)), got.numpy(), 1e-5,
                       1e-5, msg=f"cuda {strategy} W={W}")
    with pytest.raises(ValueError, match="unknown backend"):
        make_presampled_agg(ds.gcn_adj, 4, backend="cuda_fused", device=CPU)


def test_gnn_configs_match_reference():
    assert list(PAPER_GNN_CONFIGS) == list(JCONFIGS)
    for key, want in JCONFIGS.items():
        got = PAPER_GNN_CONFIGS[key]
        assert isinstance(got, GNNConfig)
        assert vars(got) == vars(want), key


# --- tests/test_gnn.py's claims, on the port's own training ---------------

@pytest.fixture(scope="module")
def proteins():
    ds = make_dataset("ogbn-proteins", scale=0.004, seed=1, device=CPU)
    params_gcn, ideal_gcn = train_model(ds, "gcn", epochs=120, seed=1,
                                        device=CPU)
    return ds, params_gcn, ideal_gcn


def _eval(ds, params, **kw):
    return evaluate(ds, kw.pop("model", "gcn"), params, device=CPU, **kw)


def test_training_beats_chance(proteins):
    _, _, ideal = proteins
    assert ideal > 0.8  # 2 classes, planted structure


def test_exact_inference_matches_ideal(proteins):
    ds, params, ideal = proteins
    assert abs(_eval(ds, params, strategy="full") - ideal) < 1e-6


def test_paper_claim_aes_beats_sfs_on_large_graph(proteins):
    ds, params, ideal = proteins
    aes = _eval(ds, params, sh_width=8, strategy="aes")
    sfs = _eval(ds, params, sh_width=8, strategy="sfs")
    assert aes > sfs
    assert ideal - aes < 0.05
    assert ideal - sfs > ideal - aes


def test_paper_claim_accuracy_increases_with_w(proteins):
    ds, params, _ = proteins
    accs = [_eval(ds, params, sh_width=w, strategy="sfs") for w in (4, 16, 64)]
    assert accs[0] <= accs[-1] + 0.01


def test_paper_claim_quantization_loss_negligible(proteins):
    ds, params, _ = proteins
    for w in (16, 64):
        for backend in ("torch", "cuda"):
            base = _eval(ds, params, sh_width=w, strategy="aes",
                         backend=backend)
            quant = _eval(ds, params, sh_width=w, strategy="aes",
                          backend=backend, quantize_bits=8)
            assert abs(base - quant) <= 0.015, (w, backend)


def test_graphsage_model(proteins):
    ds, _, _ = proteins
    params, ideal = train_model(ds, "graphsage", epochs=120, seed=1,
                                device=CPU)
    assert ideal > 0.8
    aes = _eval(ds, params, model="graphsage", sh_width=16, strategy="aes")
    assert ideal - aes < 0.05


def test_small_graph_negligible_loss():
    ds = make_dataset("cora", scale=0.5, seed=2, device=CPU)
    params, ideal = train_model(ds, "gcn", epochs=100, seed=2, device=CPU)
    aes = _eval(ds, params, sh_width=16, strategy="aes")
    assert ideal - aes < 0.02


def test_ideal_accuracy_matches_reference(proteins):
    """The port's ideal accuracy against the reference's, same dataset
    and seed, both models; and its trained GCN, converted back through
    ``params_from_numpy``, scores the same."""
    ds, params, ideal = proteins
    jds = jmake_dataset("ogbn-proteins", scale=0.004, seed=1)
    jparams, jideal = jtrain_model(jds, "gcn", epochs=120, seed=1)
    assert abs(ideal - jideal) < 0.02
    _, sage_ideal = train_model(ds, "graphsage", epochs=120, seed=1,
                                device=CPU)
    _, jsage_ideal = jtrain_model(jds, "graphsage", epochs=120, seed=1)
    assert abs(sage_ideal - jsage_ideal) < 0.02
    round_trip = params_from_numpy(
        "gcn", GCNParams(*(getattr(params, k).numpy()
                           for k in GCNParams._fields)), device=CPU)
    assert _eval(ds, round_trip, strategy="full") == ideal
    converted = params_from_numpy("gcn", jparams, device=CPU)
    assert abs(_eval(ds, converted, strategy="full") - jideal) < 1e-6


@pytest.mark.parametrize("argv, expect", [
    (["repro_torch.examples.quickstart"],
     "cuda kernel path agrees with the torch path"),
    (["repro_torch.examples.gnn_inference", "cora", "0.05"],
     "== GRAPHSAGE | ideal (exact kernel) accuracy")])
def test_example_runs_on_cpu(argv, expect):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("PYTHONSTARTUP", None)
    out = subprocess.run([sys.executable, "-m", *argv, "--device", "cpu"],
                         env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr
    assert expect in out.stdout
