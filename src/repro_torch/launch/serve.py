"""Batched LM serving driver: prefill, then a greedy decode loop, with the
paper's two levers as options: AES-KV sampling bounds the positions each
decode step reads, and the int8 KV cache (Eq. 1-2 on cache rows) halves
its bytes.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --smoke --requests 8 --gen 32 [--aes-kv 64] [--kv-int8] \
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import decode_step, forward, init_params
from repro_torch.models.attention import quantize_kv
from repro_torch.models.lm import CACHE_SEQ_AXIS


@dataclass
class ServeStats:
    prefill_s: float
    decode_s: float
    tokens: int

    @property
    def tok_per_s(self) -> float:
        return self.tokens / max(self.decode_s, 1e-9)


def _grow(a: torch.Tensor, axis: int, S_max: int) -> torch.Tensor:
    shape = list(a.shape)
    shape[axis] = S_max
    out = a.new_zeros(shape)
    out.narrow(axis, 0, a.shape[axis]).copy_(a)
    return out


def grow_cache(cache, S_max: int):
    """A prefill cache with every attention entry's sequence axis (by
    name, ``lm.CACHE_SEQ_AXIS``: K/V and their scales, MLA's latents,
    Zamba2's ``groups.k``/``v`` and a pattern's ``blocks[i].k``/``v``)
    zero-padded to ``S_max`` positions; recurrent states and conv caches
    are kept as they are."""
    if isinstance(cache, list):
        return [grow_cache(c, S_max) for c in cache]
    out = {}
    for name, a in cache.items():
        if isinstance(a, (dict, list)):
            out[name] = grow_cache(a, S_max)
        elif name in CACHE_SEQ_AXIS:
            out[name] = _grow(a, CACHE_SEQ_AXIS[name], S_max)
        else:
            out[name] = a
    return out


def check_cache_layout(cfg) -> None:
    """Refuse the int8 KV cache where the cache has no int8 layout (the
    reference fails on MLA and serves the pattern families in bfloat16
    without saying so)."""
    if cfg.mla is not None and cfg.kv_quant_bits:
        raise ValueError(f"{cfg.name}: the int8 KV cache covers K/V "
                         "caches; MLA's latent cache has no int8 layout")
    if cfg.block_pattern is not None and cfg.kv_quant_bits:
        raise ValueError(f"{cfg.name}: the int8 KV cache covers the uniform "
                         "K/V caches; the pattern families' caches (shared "
                         "attention, recurrent states) have no int8 layout")


def prefill(cfg, model, tokens: torch.Tensor, S_max: int):
    """Run the prompt ``tokens`` [B,P] and seed a decode cache of ``S_max``
    positions (int8 with scales when ``cfg.kv_quant_bits`` is set).
    Returns (logits float32 [B,P,V], cache)."""
    check_cache_layout(cfg)
    logits, _, cache = forward(model, cfg, tokens=tokens, want_cache=True,
                               remat=False)
    cache = grow_cache(cache, S_max)
    if cfg.kv_quant_bits:
        # prefill emits bfloat16 K/V; quantize it into the int8 layout
        kq, ks = quantize_kv(cache["k"], cfg.kv_quant_bits)
        vq, vs = quantize_kv(cache["v"], cfg.kv_quant_bits)
        cache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return logits, cache


def serve(cfg, model, prompts: np.ndarray, gen_len: int, *, device=None):
    """Greedy generation for ``prompts`` int32 [B, P] on ``device``
    (default ``"cuda"``; the model is moved there).  Returns (generated
    [B, gen_len] numpy int32, stats); the tokens stay on the device until
    the end, and each clock is read after the device has finished."""
    check_cache_layout(cfg)
    device = resolve_device(device)
    model = model.to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    B, P = prompts.shape
    S_max = P + gen_len
    t0 = time.perf_counter()
    logits, cache = prefill(cfg, model, torch.as_tensor(prompts,
                                                        device=device), S_max)
    tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
    sync()
    t_prefill = time.perf_counter() - t0

    out = [tok]
    t0 = time.perf_counter()
    for step in range(gen_len - 1):
        logits, cache = decode_step(model, cfg, cache, tokens=tok,
                                    cache_len=P + step)
        tok = logits.argmax(dim=-1).to(torch.int32)
        out.append(tok)
    gen = torch.cat(out, dim=1)
    sync()
    t_decode = time.perf_counter() - t0
    return gen.cpu().numpy(), ServeStats(t_prefill, t_decode, B * gen_len)


def main(argv=None) -> ServeStats:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--aes-kv", type=int, default=None,
                    help="AES-KV sampling width (paper-technique transfer)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="INT8 KV cache (paper Eq. 1-2 on cache rows)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.aes_kv:
        cfg = cfg.with_aes_kv(args.aes_kv)
    if args.kv_int8:
        cfg = cfg.with_options(kv_quant_bits=8)
    if cfg.frontend is not None:
        raise SystemExit("serve driver covers token archs; vlm/audio stubs "
                         "take embeds= through repro_torch.models.forward")

    model = init_params(cfg, 0, device=args.device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size,
                           (args.requests, args.prompt_len)).astype(np.int32)
    gen, stats = serve(cfg, model, prompts, args.gen, device=args.device)
    print(f"prefill {stats.prefill_s:.2f}s | decode {stats.decode_s:.2f}s | "
          f"{stats.tok_per_s:.1f} tok/s | first tokens {gen[:, :8].tolist()}")
    return stats


if __name__ == "__main__":
    main()
