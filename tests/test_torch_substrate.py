"""The port's training substrate against the reference's: learning-rate
schedules, int8 gradient compression with error feedback, the token
pipeline, checkpoints, the fault-tolerant runner and the training
driver, on the CPU.

Tolerances: schedules to 1e-6 relative (float32, ``cos`` from another
library); compression bit-equal in ``q`` and the scale, the residual to
1e-6 (float32); pipeline batches and checkpoint round trips bit for bit;
a resumed run equal to an uninterrupted one.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import PipelineConfig as RefPipelineConfig
from repro.data.pipeline import TokenPipeline as RefTokenPipeline
from repro.optim import compress_grads as ref_compress_grads
from repro.optim import constant as ref_constant
from repro.optim import cosine_with_warmup as ref_cosine
from repro_torch.checkpoint import (Checkpointer, latest_step, latest_steps,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.data import PipelineConfig, TokenPipeline, make_pipeline
from repro_torch.optim import (AdamWState, adamw_init, compress_grads,
                               constant, cosine_with_warmup,
                               decompress_grads)
from repro_torch.runtime import (FaultTolerantRunner, RunnerConfig,
                                 SimulatedFailure, StragglerMonitor)


# -- schedules ----------------------------------------------------------------

def test_schedules_match_reference():
    """``constant`` and ``cosine_with_warmup`` at every step of a run and
    past its end, from a Python int and from AdamW's int32 step tensor."""
    pairs = [(constant(3e-4), ref_constant(3e-4)),
             (cosine_with_warmup(1.0, 10, 100), ref_cosine(1.0, 10, 100)),
             (cosine_with_warmup(3e-4, 0, 37, final_frac=0.2),
              ref_cosine(3e-4, 0, 37, final_frac=0.2))]
    for ours, theirs in pairs:
        for step in range(0, 120, 3):
            got = ours(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.shape == ()
            assert float(ours(step)) == float(got)
            np.testing.assert_allclose(float(got), float(theirs(step)),
                                       rtol=1e-6, atol=0)
    s = cosine_with_warmup(1.0, warmup_steps=10, total_steps=100)
    assert float(s(0)) == 0.0 and abs(float(s(10)) - 1.0) < 1e-6
    assert float(s(100)) < float(s(50)) < float(s(10))


# -- gradient compression -------------------------------------------------------

def test_compress_grads_bit_equal_to_reference():
    """Random float32 gradients over four magnitudes, and one whose
    quotients by the scale land on .5 (round half to even on both
    sides): ``q`` and the scales bit-equal, the residual the exact
    rounding error."""
    rng = np.random.default_rng(0)
    grads = {f"g{i}": (rng.normal(size=(33, 7)) * 10.0 ** (i - 2)
                       ).astype(np.float32) for i in range(4)}
    grads["ties"] = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -3.5, 0.0],
                             np.float32)
    q, scales, resid = compress_grads({k: torch.from_numpy(v)
                                       for k, v in grads.items()})
    rq, rs, rr = ref_compress_grads({k: jnp.asarray(v)
                                     for k, v in grads.items()})
    np.testing.assert_array_equal(q["ties"].numpy(), [127, 0, 2, 2, 0, -4, 0])
    back = decompress_grads(q, scales)
    for k, g in grads.items():
        assert q[k].dtype == torch.int8
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(rq[k]))
        assert float(scales[k]) == float(rs[k])
        np.testing.assert_allclose(resid[k].numpy(), np.asarray(rr[k]),
                                   rtol=0, atol=1e-6 * np.abs(g).max())
        np.testing.assert_allclose(resid[k].numpy(), g - back[k].numpy(),
                                   rtol=0, atol=1e-6 * np.abs(g).max())
        assert np.abs(back[k].numpy() - g).max() <= \
            np.abs(g).max() / 127.0 * (1 + 1e-6)


def test_error_feedback_converges_in_mean():
    """With error feedback, compressed steps track the exact gradient on
    average (tests/test_substrate.py's claim), the residual carried in
    float32."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    resid, acc = None, torch.zeros(64)
    for _ in range(50):
        q, s, resid = compress_grads({"g": g_true}, resid)
        assert resid["g"].dtype == torch.float32
        acc = acc + decompress_grads(q, s)["g"]
    np.testing.assert_allclose((acc / 50).numpy(), g_true.numpy(), atol=0.02)


# -- data pipeline --------------------------------------------------------------

def test_pipeline_bit_equal_to_reference():
    """Every (seed, step, host) batch equals the reference's, bit for bit;
    labels are the next tokens; hosts get different slices."""
    for seed, hosts in ((0, 1), (3, 2), (11, 4)):
        for host in range(hosts):
            kw = dict(global_batch=8, seq_len=16, vocab_size=100, seed=seed,
                      num_hosts=hosts, host_id=host)
            ours = TokenPipeline(PipelineConfig(**kw))
            theirs = RefTokenPipeline(RefPipelineConfig(**kw))
            for step in (0, 1, 7, 1000):
                a, b = ours.batch_at(step), theirs.batch_at(step)
                assert a["tokens"].shape == (8 // hosts, 16)
                for k in ("tokens", "labels"):
                    assert a[k].dtype == b[k].dtype == np.int32
                    np.testing.assert_array_equal(a[k], b[k])
                np.testing.assert_array_equal(a["tokens"][:, 1:],
                                              a["labels"][:, :-1])
    h0, h1 = (TokenPipeline(PipelineConfig(8, 16, 100, num_hosts=2,
                                           host_id=h)) for h in (0, 1))
    assert not np.array_equal(h0.batch_at(0)["tokens"],
                              h1.batch_at(0)["tokens"])
    with pytest.raises(ValueError, match="split"):
        TokenPipeline(PipelineConfig(6, 16, 100, num_hosts=4))


def test_pipeline_prefetch_iterator():
    p = make_pipeline(PipelineConfig(global_batch=2, seq_len=8,
                                     vocab_size=50))
    it = p.iterate(start_step=5)
    for step in range(5, 9):
        np.testing.assert_array_equal(next(it)["tokens"],
                                      p.batch_at(step)["tokens"])
    it.close()


# -- checkpoints ----------------------------------------------------------------

def _train_state(seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn((4, 3), generator=gen).to(torch.bfloat16),
              "norm": torch.randn((3,), generator=gen)}
    opt = adamw_init(params)
    opt = AdamWState(opt.step + 7, {k: m + 1.5 for k, m in opt.mu.items()},
                     opt.nu)
    return params, opt


def _assert_same_tree(got, want):
    got_params, got_opt = got
    want_params, want_opt = want
    assert isinstance(got_opt, AdamWState)
    pairs = list(zip(got_params.values(), want_params.values()))
    pairs += [(got_opt.step, want_opt.step)]
    pairs += list(zip(got_opt.mu.values(), want_opt.mu.values()))
    pairs += list(zip(got_opt.nu.values(), want_opt.nu.values()))
    for a, b in pairs:
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


def test_checkpoint_roundtrip_bit_exact_and_retention(tmp_path):
    """The train state (bfloat16 parameters, float32 norms and moments,
    the int32 step) round-trips bit for bit, the bfloat16 leaves stored
    as their uint16 bits; numpy trees too; retention keeps the last 2;
    no ``.tmp`` directory is left."""
    state = _train_state()
    for s in (10, 20, 30, 40):
        save_checkpoint(tmp_path, s, state, keep=2)
    assert latest_step(tmp_path) == 40 and latest_steps(tmp_path) == [30, 40]
    assert not list(tmp_path.glob("*.tmp"))
    bits = np.load(tmp_path / "step_40" / "leaf_0.npy")
    assert bits.dtype == np.uint16
    _assert_same_tree(restore_checkpoint(tmp_path, 40, _train_state(1)),
                      state)
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "nested": {"b": np.ones(4, np.int32)}}
    save_checkpoint(tmp_path / "np", 1, tree)
    got = restore_checkpoint(tmp_path / "np", 1, tree)
    np.testing.assert_array_equal(got["w"], tree["w"])
    np.testing.assert_array_equal(got["nested"]["b"], tree["nested"]["b"])


def test_checkpoint_structure_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path, 1, {"a": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(tmp_path, 1, {"a": torch.zeros(3),
                                         "b": torch.zeros(2)})
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(tmp_path, 1, {"b": torch.zeros(3)})
    with pytest.raises(ValueError, match="structure mismatch"):
        restore_checkpoint(tmp_path, 1, {"a": torch.zeros(4)})


def test_async_checkpointer_and_restore_latest(tmp_path):
    ck = Checkpointer(tmp_path, every=5, keep=2)
    w = torch.arange(4.0)
    for step in range(1, 16):
        assert ck.maybe_save(step, {"w": w * step}) == (step % 5 == 0)
    ck.wait()
    restored, step = ck.restore_latest({"w": w})
    assert step == 15 and latest_steps(tmp_path) == [10, 15]
    assert torch.equal(restored["w"], w * 15)
    assert Checkpointer(tmp_path / "empty").restore_latest({"w": w}) == \
        (None, 0)


# -- fault-tolerant runner --------------------------------------------------------

def _problem():
    def step_fn(state, batch):
        p = state - 0.05 * 2 * state * batch["x"]
        return p, {"loss": p[0] ** 2}

    return torch.tensor([5.0]), step_fn, lambda step: {"x": torch.ones(1)}


def test_runner_failure_injection_and_resume(tmp_path):
    """An injected failure at step 25 leaves step 20's checkpoint; a new
    runner resumes from it and ends bit-equal to an uninterrupted run."""
    params, step_fn, batch_at = _problem()
    runner = FaultTolerantRunner(RunnerConfig(
        total_steps=40, ckpt_dir=str(tmp_path), ckpt_every=10,
        inject_failure_at=25))
    with pytest.raises(SimulatedFailure):
        runner.run(step_fn, params, batch_at, start_step=0)
    assert latest_step(tmp_path) == 20
    state, step, _ = FaultTolerantRunner(RunnerConfig(
        total_steps=40, ckpt_dir=str(tmp_path), ckpt_every=10)).run(
        step_fn, params, batch_at)
    assert step == 40
    clean, _, _ = FaultTolerantRunner(RunnerConfig(
        total_steps=40, ckpt_dir=str(tmp_path / "clean"),
        ckpt_every=100)).run(step_fn, params, batch_at, start_step=0)
    assert torch.equal(state, clean)


def test_straggler_monitor():
    m = StragglerMonitor(factor=3.0, alpha=0.5)
    assert not m.observe(1, 1.0)
    assert not m.observe(2, 1.1)
    assert m.observe(3, 10.0)       # breach
    assert m.breaches == [(3, 10.0)]
    hits = []
    runner = FaultTolerantRunner(RunnerConfig(total_steps=3, ckpt_dir="x",
                                              ckpt_every=100),
                                 on_straggler=lambda s, t: hits.append(s))
    assert runner.monitor.factor == 3.0 and hits == []


# -- the training driver ----------------------------------------------------------

def _main(tmp_path, *extra):
    from repro_torch.launch.train import main

    return main(["--arch", "qwen1.5-0.5b", "--smoke", "--steps", "25",
                 "--seq", "32", "--batch", "4", "--device", "cpu",
                 "--ckpt-dir", str(tmp_path), *extra])


@pytest.mark.parametrize("extra", [(), ("--grad-compress",)],
                         ids=["plain", "grad-compress"])
def test_train_launcher_end_to_end(tmp_path, extra):
    """tests/test_substrate.py's launcher claims: a reduced model trains
    on the CPU and its loss drops, with and without int8 compression."""
    losses = _main(tmp_path, *extra)
    assert len(losses) == 25 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_train_launcher_resume_equals_uninterrupted(tmp_path):
    """An injected failure at step 15 (checkpoints every 5), then
    ``--resume``: steps 15-24 give the losses of an uninterrupted run."""
    clean = _main(tmp_path / "clean", "--ckpt-every", "100")
    with pytest.raises(SimulatedFailure):
        _main(tmp_path / "ft", "--ckpt-every", "5",
              "--inject-failure-at", "15")
    assert latest_step(tmp_path / "ft") == 15
    resumed = _main(tmp_path / "ft", "--ckpt-every", "5", "--resume")
    assert resumed == clean[15:]


def test_train_launcher_refuses_the_mesh_and_defaults_to_the_card(tmp_path):
    """The production meshes need 256 and 512 ranks: on one process the
    mesh's own check raises ``ValueError`` naming them."""
    from repro_torch.launch.train import main

    for flag, ranks in (("--production-mesh", "256"), ("--multi-pod", "512")):
        with pytest.raises(ValueError, match=ranks):
            main(["--smoke", "--steps", "1", "--device", "cpu", flag])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_lm_train_example():
    from repro_torch.examples import lm_train

    losses = lm_train.main(["qwen1.5-0.5b", "12", "--device", "cpu"])
    assert len(losses) == 12 and losses[-1] < losses[0]
