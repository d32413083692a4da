#!/usr/bin/env python3
"""Hold the main path's logits of two checkouts of the port against each
other on one CUDA card.

    python3 scripts/compare_logits.py OLD_CHECKOUT NEW_CHECKOUT

For each checkout a child process imports the ``repro_torch`` under its
``src/``, builds its kernels, makes reddit at full size
(``make_dataset("reddit", scale=1.0, max_avg_degree=None)``) and computes
``infer_logits`` for the kernel paths of ``chip_smoke.py``'s main path, with
the same random parameters (numpy seed 0, hidden 64, W = 128).  Prints one
JSON line per path with the largest difference between the two and whether
they are bit-identical, then the card's name and power limit; exits 1 where
a path differs.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
from pathlib import Path

#: (model, strategy, backend, quantize_bits, fuse_layers)
PATHS = (("gcn", "aes", "cuda", None, False),
         ("gcn", "aes", "cuda", None, True),
         ("gcn", "aes", "cuda", 8, False),
         ("gcn", "aes", "cuda", 8, True),
         ("gcn", "aes", "cuda_fused", None, False),
         ("graphsage", "aes", "cuda", None, False))


def child(checkout: str, out: str) -> None:
    """Compute every path's logits with the port of ``checkout``; save
    them to ``out``."""
    sys.path.insert(0, str(Path(checkout).resolve() / "src"))
    import numpy as np
    import torch

    from repro_torch.gnn import infer_logits, make_dataset
    from repro_torch.gnn.models import MODELS

    torch.backends.cuda.matmul.allow_tf32 = False
    ds = make_dataset("reddit", scale=1.0, seed=0, max_avg_degree=None,
                      device="cuda")
    logits = {}
    for model, strategy, backend, bits, fuse in PATHS:
        params = MODELS[model][0](np.random.default_rng(0),
                                  ds.features.shape[1], 64,
                                  ds.spec.num_classes, device="cuda")
        logits[repr((model, strategy, backend, bits, fuse))] = infer_logits(
            ds, model, params, sh_width=128, strategy=strategy,
            backend=backend, quantize_bits=bits, fuse_layers=fuse,
            device="cuda").cpu()
    torch.save(logits, out)


def main() -> None:
    if sys.argv[1:2] == ["--child"]:
        child(*sys.argv[2:4])
        return
    old, new = sys.argv[1:3]
    import torch

    with tempfile.TemporaryDirectory() as tmp:
        got = []
        for i, checkout in enumerate((old, new)):
            out = str(Path(tmp) / f"{i}.pt")
            subprocess.run([sys.executable, __file__, "--child", checkout,
                            out], check=True)
            got.append(torch.load(out))
    differ = False
    for key, a in got[0].items():
        b = got[1][key]
        same = torch.equal(a.view(torch.int32), b.view(torch.int32))
        differ |= not same
        print(json.dumps({"path": key, "bit_identical": same,
                          "max_abs_diff": float((a - b).abs().max())}),
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    sys.exit(1 if differ else 0)


if __name__ == "__main__":
    main()
