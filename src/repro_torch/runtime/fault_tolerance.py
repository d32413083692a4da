"""Fault-tolerant training runtime.

The runner composes:

  * checkpoint/restart — a crash at step k resumes from the newest atomic
    checkpoint; data order replays exactly (step-indexed pipeline);
  * straggler mitigation — per-step deadline tracking with an EWMA of
    step time; a step breaching ``straggler_factor`` x EWMA is logged and
    counted (the hook is ``on_straggler``);
  * elastic restart — the state is restored whole and each tensor moved
    to the device of the live state's tensor it replaces;
  * failure injection — ``inject_failure_at`` stops the loop at a chosen
    step so tests exercise the restart path end to end.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import flatten, unflatten


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class RunnerConfig:
    total_steps: int
    ckpt_dir: str
    ckpt_every: int = 50
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.2
    inject_failure_at: Optional[int] = None


class StragglerMonitor:
    """EWMA step-time tracker with a deadline breach counter."""

    def __init__(self, factor: float = 3.0, alpha: float = 0.2):
        self.factor = factor
        self.alpha = alpha
        self.ewma: float | None = None
        self.breaches: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = (self.ewma is not None and
                        dt > self.factor * self.ewma)
        if is_straggler:
            self.breaches.append((step, dt))
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        return is_straggler


def _place(restored, live):
    """``restored``'s tensors on the devices of ``live``'s."""
    return unflatten(live, (
        r.to(s.device) if isinstance(s, torch.Tensor) else r
        for (_, r), (_, s) in zip(flatten(restored), flatten(live))))


def _block_until_ready(state) -> None:
    """Wait for the device that holds the state's first tensor."""
    leaves = [leaf for _, leaf in flatten(state)
              if isinstance(leaf, torch.Tensor)]
    if leaves and leaves[0].device.type == "cuda":
        torch.cuda.synchronize(leaves[0].device)


class FaultTolerantRunner:
    """Drives (state, batch) -> (state, metrics) step functions with
    checkpointing, deterministic resume, and straggler accounting."""

    def __init__(self, cfg: RunnerConfig,
                 on_straggler: Callable[[int, float], None] | None = None):
        self.cfg = cfg
        self.ckpt = Checkpointer(cfg.ckpt_dir, every=cfg.ckpt_every)
        self.monitor = StragglerMonitor(cfg.straggler_factor, cfg.ewma_alpha)
        self.on_straggler = on_straggler or (lambda s, t: None)

    def run(self, step_fn, state, batch_at: Callable[[int], dict],
            start_step: int | None = None):
        """Returns (final state, steps done, last metrics).

        If ``start_step`` is None, resumes from the latest checkpoint
        (restored into the structure of ``state``, on its devices).
        """
        if start_step is None:
            restored, step = self.ckpt.restore_latest(state)
            if restored is not None:
                state = _place(restored, state)
        else:
            step = start_step

        metrics = None
        while step < self.cfg.total_steps:
            if self.cfg.inject_failure_at is not None and \
                    step == self.cfg.inject_failure_at:
                self.ckpt.wait()
                raise SimulatedFailure(f"injected failure at step {step}")
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch_at(step))
            _block_until_ready(state)
            dt = time.perf_counter() - t0
            step += 1
            if self.monitor.observe(step, dt):
                self.on_straggler(step, dt)
            self.ckpt.maybe_save(step, state)
        self.ckpt.wait()
        return state, step, metrics
