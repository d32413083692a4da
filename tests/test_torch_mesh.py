"""The port's device mesh on the CPU: ``launch.mesh`` over fake process
groups, ``launch.train`` on a mesh, DTensor steps against the plain step,
checkpoints across mesh shapes and one dry-run cell.

Every process group a test starts it destroys (or it runs in a
subprocess), so no later test finds one.  Tolerances: on a one-rank mesh
the DTensor step is the plain step, bit for bit (every reduction is over
one rank); on a (2, 2) mesh of four processes the gradients agree to 1e-5
of each gradient's largest magnitude and the loss and parameters after
two float32 steps to 1e-5 (sums over two ranks in another order).  The
learning rate there is 5e-5: where a gradient is below AdamW's eps (1e-8)
its update is about g / eps, so a rounding difference dg in it moves the
parameter by lr * dg / eps -- 1.25e-5 at lr 1e-4 on one qwen1.5 weight
whose gradient is 2.3e-9.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import ALL_ARCHS, get_config, smoke_config
from repro_torch.data import make_pipeline
from repro_torch.distributed.sharding import batch_shardings, place
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.train import (make_train_step, sharded_step,
                                      state_shardings, value_and_grad)
from repro_torch.models import init_params
from repro_torch.optim import adamw_init, constant
from repro_torch.runtime.fault_tolerance import _place

REPO = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def group(backend: str = "gloo", ranks: int = 1):
    """A default process group for the test's length (``fake``: ``ranks``
    fake ranks, this process rank 0)."""
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore

        store = FakeStore()
    else:
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=0, world_size=ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("PYTHONSTARTUP", None)
    return env


def test_production_meshes_over_fake_groups():
    for multi_pod, ranks, names, sizes in (
            (False, 256, ("data", "model"), (16, 16)),
            (True, 512, ("pod", "data", "model"), (2, 16, 16))):
        with group("fake", ranks):
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
            assert mesh.mesh_dim_names == names
            assert tuple(mesh.shape) == sizes
            assert list(mesh.get_coordinate()) == [0] * len(sizes)
    with group():
        for multi_pod, need in ((False, "256"), (True, "512")):
            with pytest.raises(ValueError, match=need):
                make_production_mesh(multi_pod=multi_pod, device="cpu")
        mesh = make_local_mesh(device="cpu")
        assert tuple(mesh.shape) == (1, 1)
    with pytest.raises(ValueError, match="256"):
        make_production_mesh(device="cpu")      # no group: one rank
    assert not dist.is_initialized()


def test_train_main_checks_the_mesh_and_leaves_no_group(tmp_path):
    from repro_torch.launch.train import main

    for flag, need in (("--production-mesh", "256"), ("--multi-pod", "512")):
        with pytest.raises(ValueError, match=need):
            main(["--smoke", "--steps", "1", "--device", "cpu",
                  "--ckpt-dir", str(tmp_path), flag])
        assert not dist.is_initialized()
    losses = main(["--smoke", "--steps", "2", "--seq", "32", "--batch", "2",
                   "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert not dist.is_initialized()


def test_one_rank_mesh_steps_are_the_plain_step_bit_for_bit():
    """All ten smoke configs: loss and every gradient of the DTensor step
    equal to the plain step's, then two AdamW steps' parameters."""
    with group():
        mesh = make_local_mesh(device="cpu")
        for arch in ALL_ARCHS:
            cfg = smoke_config(get_config(arch))
            model = init_params(cfg, 0, device="cpu")
            params = {k: p.detach() for k, p in model.named_parameters()}
            pipe = make_pipeline(cfg, seq_len=16, global_batch=2)
            batches = [{k: torch.as_tensor(v)
                        for k, v in pipe.batch_at(i).items()}
                       for i in range(2)]
            state = (params, adamw_init(params))
            specs = state_shardings(mesh, state)
            placed = place(state, specs, mesh)
            assert all(isinstance(t, DTensor) for t in placed[0].values())
            loss, grads = value_and_grad(model, cfg, params, batches[0])
            with implicit_replication():
                dloss, dgrads = value_and_grad(
                    model, cfg, placed[0],
                    place(batches[0], batch_shardings(mesh, batches[0]),
                          mesh))
            assert torch.equal(loss, dloss.full_tensor()), arch
            for k, g in grads.items():
                assert torch.equal(g, dgrads[k].full_tensor()), (arch, k)
            step = make_train_step(cfg, model, constant(1e-3))
            dstep = sharded_step(step, mesh, specs)
            for batch in batches:
                state, metrics = step(state, batch)
                placed, dmetrics = dstep(placed, batch)
                assert torch.equal(metrics["loss"], dmetrics["loss"]), arch
            for k, p in state[0].items():
                assert torch.equal(p, placed[0][k].full_tensor()), (arch, k)


_WORKER = r'''
import sys
import torch, torch.distributed as dist
import torch.multiprocessing as mp


def run(rank, store_path, archs):
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import make_pipeline
    from repro_torch.distributed.sharding import batch_shardings, place
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import (make_train_step, sharded_step,
                                          state_shardings, value_and_grad)
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init, constant

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4),
                            rank=rank, world_size=4)
    try:
        mesh = make_local_mesh(model=2, device="cpu")
        for arch in archs:
            cfg = smoke_config(get_config(arch)).with_options(
                param_dtype="float32")
            model = init_params(cfg, 0, device="cpu")
            params = {k: p.detach() for k, p in model.named_parameters()}
            state = (params, adamw_init(params))
            pipe = make_pipeline(cfg, seq_len=32, global_batch=4)
            batches = [{k: torch.as_tensor(v)
                        for k, v in pipe.batch_at(i).items()}
                       for i in range(2)]
            specs = state_shardings(mesh, state)
            placed = place(state, specs, mesh)
            with implicit_replication():
                _, dgrads = value_and_grad(model, cfg, placed[0], place(
                    batches[0], batch_shardings(mesh, batches[0]), mesh))
            dgrads = {k: g.full_tensor() for k, g in dgrads.items()}
            step = make_train_step(cfg, model, constant(5e-5))
            dstep = sharded_step(step, mesh, specs)
            dlosses = []
            for b in batches:
                placed, m = dstep(placed, b)
                dlosses.append(float(m["loss"]))
            full = {k: v.full_tensor() for k, v in placed[0].items()}
            if rank == 0:
                _, grads = value_and_grad(model, cfg, params, batches[0])
                grad_err = max(float((grads[k] - dgrads[k]).abs().max())
                               / max(float(grads[k].abs().max()), 1e-30)
                               for k in grads)
                losses = []
                for b in batches:
                    state, m = step(state, b)
                    losses.append(float(m["loss"]))
                loss_err = max(abs(a - b) for a, b in zip(dlosses, losses))
                param_err = max(float((full[k] - state[0][k]).abs().max())
                                for k in full)
                print(f"RESULT {arch} {grad_err} {loss_err} {param_err}",
                      flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(run, args=(sys.argv[1], sys.argv[2:]), nprocs=4,
                       start_method="spawn")
'''


def test_two_by_two_gloo_mesh_matches_one_process(tmp_path):
    """Four processes on a (2, 2) gloo mesh (batch over data, heads and
    experts over model), smoke qwen1.5-0.5b (dense) and mixtral-8x22b
    (MoE), float32: gradients, then two steps' losses and parameters,
    against the plain step in one process."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    out = subprocess.run(
        [sys.executable, str(script), str(tmp_path / "store"),
         "qwen1.5-0.5b", "mixtral-8x22b"], env=_env(), capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    results = [line.split() for line in out.stdout.splitlines()
               if line.startswith("RESULT")]
    assert [r[1] for r in results] == ["qwen1.5-0.5b", "mixtral-8x22b"]
    for _, arch, grad_err, loss_err, param_err in results:
        assert float(grad_err) <= 1e-5, (arch, grad_err)
        assert float(loss_err) <= 1e-5, (arch, loss_err)
        assert float(param_err) <= 1e-5, (arch, param_err)


def test_elastic_restore_across_mesh_shapes(tmp_path):
    """A state saved sharded (``Shard(1)`` over model) comes back whole
    and is re-placed replicated on another mesh, as the live state's
    placements say."""
    with group():
        mesh_a = make_local_mesh(device="cpu")
        w = torch.arange(16.0).reshape(4, 4)
        sharded = DTensor.from_local(w, mesh_a, [Replicate(), Shard(1)])
        save_checkpoint(tmp_path, 7, {"w": sharded})
        from torch.distributed.device_mesh import init_device_mesh

        mesh_b = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        live = {"w": DTensor.from_local(torch.zeros(4, 4), mesh_b,
                                        [Replicate()])}
        got = _place(restore_checkpoint(tmp_path, 7, live), live)
        assert isinstance(got["w"], DTensor)
        assert got["w"].device_mesh is mesh_b
        assert got["w"].placements == (Replicate(),)
        assert torch.equal(got["w"].full_tensor(), w)


def test_dryrun_cell_subprocess():
    """One dry-run cell over a fake 256-rank group in a fresh process, as
    the reference's ``test_dryrun_cell_subprocess``; and the ``long_500k``
    SKIP rule for a full-attention arch (no group started)."""
    import json

    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b", "--shape", "decode_32k", "--device", "cpu"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=REPO)
    assert "decode_32k/16x16: OK" in out.stdout, out.stdout + out.stderr[-3000:]
    from repro_torch.launch.dryrun import ART, run_cell

    record = json.loads(
        (ART / "tinyllama-1.1b__decode_32k__16x16.json").read_text())
    assert record["ranks"] == 256 and record["registered_strategies"]
    # the measured local bytes are the rules' shard bytes, which
    # tests/test_torch_sharding.py holds equal to the reference's
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.mesh_compat import abstract_mesh
    from repro_torch.launch.dryrun import argument_bytes, build_cell

    mesh = abstract_mesh((16, 16), ("data", "model"))
    with FakeTensorMode():
        _, args, specs = build_cell("tinyllama-1.1b", "decode_32k", mesh,
                                    device="cpu")
        assert record["memory"]["argument_bytes"] == argument_bytes(
            args, specs, mesh)
    assert record["memory"]["peak_bytes"] >= record["memory"][
        "argument_bytes"]
    skip = run_cell("qwen2-7b", "long_500k", False, save=False,
                    verbose=False, device="cpu")
    assert skip["status"] == "SKIP" and "quadratic" in skip["reason"]
    assert not dist.is_initialized()
