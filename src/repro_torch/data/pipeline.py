"""Deterministic, resumable, host-sharded token pipeline (numpy only: the
port's own copy of the reference's, batch for batch).

Design constraints from the fault-tolerance story:

  * step-indexed determinism: batch(step) is a pure function of
    (seed, step, host_id) — restart from checkpoint step k reproduces the
    exact data order with no persisted iterator state;
  * host sharding: each host generates only its slice of the global batch;
  * background prefetch: a small thread pool keeps ``prefetch`` batches
    ahead of the training loop (host-side; device transfer is the
    launcher's job).

Synthetic corpus: zipf-distributed draws keyed by (seed, step, host)
stand in for tokenized text; swapping in a real corpus only replaces
``_synthesize``.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class PipelineConfig:
    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2


class TokenPipeline:
    def __init__(self, cfg: PipelineConfig):
        if cfg.global_batch % cfg.num_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {cfg.num_hosts} hosts")
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.num_hosts

    # -- deterministic batch synthesis -------------------------------------
    def _synthesize(self, step: int) -> dict:
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.host_id]))
        # zipf-ish marginal over the vocab, mimicking natural token stats
        z = rng.zipf(1.3, size=(self.local_batch, c.seq_len + 1))
        tokens = (z % (c.vocab_size - 1)).astype(np.int32) + 1
        return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}

    def batch_at(self, step: int) -> dict:
        """Pure function of step — the resume contract."""
        return self._synthesize(step)

    # -- prefetching iterator ----------------------------------------------
    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        c = self.cfg
        q: queue.Queue = queue.Queue(maxsize=c.prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self.batch_at(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def make_pipeline(cfg_or_arch, seq_len: int | None = None,
                  global_batch: int | None = None, **kw) -> TokenPipeline:
    """A pipeline from a ``PipelineConfig``, or from an arch config (its
    vocabulary) with ``seq_len``, ``global_batch`` and ``PipelineConfig``'s
    other fields as keywords.  (The reference takes a ``PipelineConfig``
    for an arch config, since both have ``vocab_size``, and fails.)"""
    if isinstance(cfg_or_arch, PipelineConfig):
        return TokenPipeline(cfg_or_arch)
    return TokenPipeline(PipelineConfig(
        global_batch=global_batch, seq_len=seq_len,
        vocab_size=cfg_or_arch.vocab_size, **kw))
