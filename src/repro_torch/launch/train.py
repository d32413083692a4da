"""End-to-end LM training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
        --steps 200 --seq 256 --batch 8 [--smoke] [--grad-compress] \
        [--device cuda|cpu]

``--smoke`` swaps in the reduced config, which trains for a few hundred
steps on the CPU.  Composes the substrate: config registry, data
pipeline, AdamW + cosine schedule, fault-tolerant runner
(checkpoint/resume, straggler monitor), optional int8 gradient
compression.  The train state is ``(params, AdamWState)``, ``params`` a
dict of tensors by parameter name; a step runs ``loss_fn`` on them
through ``torch.func.functional_call`` and returns a new state, as pure
as the reference's jitted step.

The mesh is the reference's: ``--production-mesh``/``--multi-pod`` the
(16, 16)/(2, 16, 16) mesh over the default process group (256/512
ranks, e.g. one process a GPU under ``torchrun``), else a local
(ranks, 1) mesh; without a group the driver starts a one-rank group
itself and ends it on exit.  On a mesh of more than one rank the
parameters, AdamW state and batches are DTensors placed by
``distributed.sharding``'s rules and the step runs on them
(:func:`sharded_step`); on one rank the rules are checked against every
shape and the tensors stay plain (DTensor on one rank only adds host
dispatch).
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.func import functional_call

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import make_pipeline
from repro_torch.distributed.sharding import (batch_shardings, check_specs,
                                              opt_shardings, param_shardings,
                                              place, to_placements, zip_map)
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import init_params, loss_fn
from repro_torch.optim import (adamw_init, adamw_update, compress_grads,
                               cosine_with_warmup, decompress_grads)
from repro_torch.runtime import FaultTolerantRunner, RunnerConfig


def value_and_grad(model, cfg, params: dict, batch: dict):
    """(loss, grads) of ``loss_fn`` at ``params`` (parameter name ->
    tensor) on ``model``'s structure.  The gradients are taken inside
    ``functional_call``, so checkpointed layers recompute with ``params``
    too; a parameter the loss does not reach gets a zero gradient."""
    live = {k: v.detach().requires_grad_() for k, v in params.items()}

    def loss_and_grads(module):
        loss = loss_fn(module, cfg, batch)
        grads = torch.autograd.grad(loss, list(live.values()),
                                    allow_unused=True)
        return loss.detach(), grads

    loss, grads = functional_call(model, live, (loss_and_grads,))
    return loss, {k: torch.zeros_like(p) if g is None else g
                  for (k, p), g in zip(live.items(), grads)}


def make_train_step(cfg, model, lr_sched, grad_compress: bool = False):
    """``train_step((params, opt), batch) -> ((params, opt), metrics)``:
    AdamW at ``lr_sched(opt.step)`` with weight decay 0.1, after an int8
    compression round trip of the gradients when ``grad_compress``."""
    def train_step(state, batch):
        params, opt = state
        loss, grads = value_and_grad(model, cfg, params, batch)
        if grad_compress:
            # int8 compression where the cross-pod all-reduce would run;
            # on one device this exercises the numerics path
            q, scales, _ = compress_grads(grads)
            grads = decompress_grads(q, scales)
        params, opt = adamw_update(grads, opt, params,
                                   lr=lr_sched(opt.step), weight_decay=0.1)
        return (params, opt), {"loss": loss}

    return train_step


def state_shardings(mesh, state, zero1: bool = False) -> tuple:
    """The specs of a train state ``(params, AdamWState)`` by the rules."""
    params, opt = state
    return (param_shardings(mesh, params),
            opt_shardings(mesh, opt, zero1=zero1))


def sharded_step(step_fn, mesh, specs):
    """``step_fn`` on DTensors: the state, placed by ``specs`` (see
    :func:`state_shardings` and ``sharding.place``), stays so across
    steps; each batch of full tensors is placed by ``batch_shardings``.
    The model's own plain tensors (positions, masks, RoPE tables) join
    the DTensors as replicated (``implicit_replication``).  The new state
    is redistributed back to ``specs`` (a pending sum is reduced there)
    and the loss returned whole."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    def to_specs(t, spec):
        return t.redistribute(mesh, to_placements(spec, mesh))

    def step(state, batch):
        batch = place(batch, batch_shardings(mesh, batch), mesh)
        with implicit_replication():
            state, metrics = step_fn(state, batch)
        state = zip_map(to_specs, state, specs)
        return state, {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}

    return step


def _own_group(device: torch.device) -> bool:
    """Starts a one-rank process group (nccl on a card, gloo on the CPU)
    unless one exists; True if it started one."""
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    return True


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    own_group = _own_group(device)
    try:
        return _train(args, device)
    finally:
        if own_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(args, device: torch.device) -> list:
    mesh = (make_production_mesh(multi_pod=args.multi_pod, device=device)
            if args.production_mesh or args.multi_pod
            else make_local_mesh(device=device))
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)

    pipe = make_pipeline(cfg, seq_len=args.seq, global_batch=args.batch)
    model = init_params(cfg, 0, device=device)
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt = adamw_init(params)
    sched = cosine_with_warmup(args.lr, warmup_steps=max(args.steps // 20, 1),
                               total_steps=args.steps)
    step_fn = make_train_step(cfg, model, sched, args.grad_compress)
    state = (params, opt)
    specs = state_shardings(mesh, state)
    if mesh.size() > 1:
        state = place(state, specs, mesh)
        step_fn = sharded_step(step_fn, mesh, specs)
    else:
        check_specs(state, specs, mesh)
        check_specs(pipe.batch_at(0), batch_shardings(mesh, pipe.batch_at(0)),
                    mesh)
    runner = FaultTolerantRunner(RunnerConfig(
        total_steps=args.steps, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
        inject_failure_at=args.inject_failure_at))

    losses = []
    t0 = time.time()

    def batch_at(step):
        return {k: torch.as_tensor(v, device=device)
                for k, v in pipe.batch_at(step).items()}

    def step_and_log(state, batch):
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        step = len(losses)
        if step % 20 == 0 or step == 1:
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"({(time.time() - t0) / step:.3f}s/step)", flush=True)
        return state, metrics

    state, step, metrics = runner.run(
        step_and_log, state, batch_at,
        start_step=None if args.resume else 0)

    print(f"done: {step} steps, final loss {losses[-1]:.4f} "
          f"(first {losses[0]:.4f})")
    if runner.monitor.breaches:
        print(f"stragglers detected: {len(runner.monitor.breaches)}")
    return losses


if __name__ == "__main__":
    main()
