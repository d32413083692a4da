"""End-to-end LM training example: trains a reduced model for a few
hundred steps through the whole substrate — config registry,
deterministic data pipeline, AdamW + cosine schedule, fault-tolerant
runner with async checkpoints (under ``artifacts/``).

    PYTHONPATH=src python -m repro_torch.examples.lm_train [arch] [steps] \
        [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.launch.train import main as train


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="tinyllama-1.1b")
    ap.add_argument("steps", nargs="?", default="200")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    losses = train(["--arch", args.arch, "--smoke", "--steps", args.steps,
                    "--seq", "128", "--batch", "8",
                    "--ckpt-dir", "artifacts/ckpt_example",
                    "--device", args.device])
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps")
    if not losses[-1] < losses[0]:
        raise AssertionError("the loss did not fall")
    return losses


if __name__ == "__main__":
    main()
