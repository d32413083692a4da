"""Paper-technique transfer demo: AES-KV sampled attention for serving.

    PYTHONPATH=src python -m repro_torch.examples.aes_kv_serving [--device cuda|cpu]

The KV cache of a decode step is the "neighbor list" of the new token; the
paper's adaptive strategy table and hash sample it down to a fixed budget
W, as AES-SpMM samples a CSR row into shared memory.  Serves Qwen2-7B's
smoke config with full attention and at W = 32 and 16 on ``--device``
(default ``cuda``).  Returns the greedy-token agreement of each width with
full attention.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.serve import serve
from repro_torch.models import init_params


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args(argv).device)

    cfg = smoke_config(get_config("qwen2-7b"))
    model = init_params(cfg, 0, device=device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size, (4, 48)).astype(np.int32)

    gen_full, s_full = serve(cfg, model, prompts, gen_len=24, device=device)
    print(f"full attention : {s_full.tok_per_s:6.1f} tok/s")
    agreement = {}
    for W in (32, 16):
        gen_w, s_w = serve(cfg.with_aes_kv(W), model, prompts, gen_len=24,
                           device=device)
        agreement[W] = float((gen_w == gen_full).mean())
        print(f"AES-KV  W={W:<4}  : {s_w.tok_per_s:6.1f} tok/s | "
              f"greedy-token agreement vs full: {agreement[W]:.2%} "
              f"(untrained weights: a sampling-sensitivity probe, not "
              f"accuracy)")
    return agreement


if __name__ == "__main__":
    main()
