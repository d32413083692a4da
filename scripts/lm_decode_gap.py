#!/usr/bin/env python3
"""Decode-vs-forward gap of one LM package on the CPU: the greedy decode
step at ``cache_len = P`` after a prefill of P tokens, against
``forward`` over the P + 1 tokens (padded with copies of the new token
to whole 128-position scan chunks; later positions cannot reach P), as
max |difference| / max |logit|.

    PYTHONPATH=src python scripts/lm_decode_gap.py --package repro \
        --arch xlstm-350m --dtype bfloat16
    PYTHONPATH=src python scripts/lm_decode_gap.py --package repro_torch \
        --arch xlstm-350m --dtype float32 [--layers 8]

Full width, random weights (the package's own init, seed 0), 2 prompts
of 128 tokens from numpy seed 0.  It imports only the package asked for.
"""
from __future__ import annotations

import argparse

import numpy as np

P, CHUNK = 128, 128


def _config(get_config, arch, dtype, layers):
    cfg = get_config(arch).with_options(param_dtype=dtype)
    if layers:
        cfg = cfg.with_options(num_layers=layers,
                               block_pattern=cfg.block_pattern[:layers])
    return cfg


def gap_repro(arch, dtype, layers, tokens) -> tuple:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models import decode_step, forward, init_params

    cfg = _config(get_config, arch, dtype, layers)
    params = init_params(cfg, jax.random.PRNGKey(0))
    tokens = jnp.asarray(tokens)
    logits, _, cache = forward(params, cfg, tokens=tokens, want_cache=True,
                               remat=False)
    tok = jnp.argmax(logits[:, -1:], -1).astype(jnp.int32)
    dec, _ = decode_step(params, cfg, cache, tokens=tok,
                         cache_len=jnp.int32(P))
    seq = jnp.concatenate([tokens, jnp.broadcast_to(tok, (2, CHUNK))], 1)
    full, _, _ = forward(params, cfg, tokens=seq, remat=False)
    last = full[:, P:P + 1]
    return float(jnp.abs(dec - last).max()), float(jnp.abs(last).max())


def gap_repro_torch(arch, dtype, layers, tokens) -> tuple:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prefill
    from repro_torch.models import decode_step, forward, init_params

    cfg = _config(get_config, arch, dtype, layers)
    model = init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(tokens)
    with torch.no_grad():
        logits, cache = prefill(cfg, model, tokens, P + CHUNK)
        tok = logits[:, -1:].argmax(-1).to(torch.int32)
        dec, _ = decode_step(model, cfg, cache, tokens=tok, cache_len=P)
        seq = torch.cat([tokens, tok.expand(-1, CHUNK)], 1)
        full, _, _ = forward(model, cfg, tokens=seq)
    last = full[:, P:P + 1]
    return float((dec - last).abs().max()), float(last.abs().max())


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("repro", "repro_torch"),
                    required=True)
    ap.add_argument("--arch", default="xlstm-350m")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--layers", type=int, default=0,
                    help="the first N layers only (0: all)")
    args = ap.parse_args(argv)
    tokens = np.random.default_rng(0).integers(
        1, 32000, (2, P)).astype(np.int32)
    gap = gap_repro if args.package == "repro" else gap_repro_torch
    err, scale = gap(args.arch, args.dtype, args.layers, tokens)
    out = {"package": args.package, "arch": args.arch, "dtype": args.dtype,
           "layers": args.layers or "all", "max_abs_err": err,
           "max_abs_logit": scale, "rel_err": err / scale}
    print(out)
    return out


if __name__ == "__main__":
    main()
