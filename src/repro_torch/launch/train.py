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
as the reference's jitted step.  One device: the production mesh is the
next slice of the port.
"""
from __future__ import annotations

import argparse
import time

import torch
from torch.func import functional_call

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import make_pipeline
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

    if args.production_mesh or args.multi_pod:
        raise NotImplementedError(
            "--production-mesh/--multi-pod: the device mesh (launch/mesh.py, "
            "distributed/sharding.py) is the next slice of the port; this "
            "driver trains on one device")
    device = resolve_device(args.device)
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
        step_and_log, (params, opt), batch_at,
        start_step=None if args.resume else 0)

    print(f"done: {step} steps, final loss {losses[-1]:.4f} "
          f"(first {losses[0]:.4f})")
    if runner.monitor.breaches:
        print(f"stragglers detected: {len(runner.monitor.breaches)}")
    return losses


if __name__ == "__main__":
    main()
