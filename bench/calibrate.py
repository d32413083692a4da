"""Readings that set a cell's output limits, on the card, many seeds in one
process (the benchmark's own runs do not run this).

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 3 ... [--control-seeds K]

For each seed it builds the cell's graph, features and weights as a run
does, serves every pool entry once through the timed entry
(``infer_logits`` with the cell's mix), and prints one JSON line with
every number the check can compare (``run.NUMBERS``):

  * ``program``: the worst of each number over the pool, the program's
    outputs against the float64 reference (the lower readings);
  * ``controls``: the best of each number over the pool for each control
    put in the program's place (first ``--control-seeds`` seeds only): the
    reference computed in TF32 for a float32 mix; at 4 bits, and at 8
    bits in TF32, for an 8-bit one (the upper readings).

The last line sums them up: for each number the largest program reading,
and for each control the smallest reading over the seeds.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]

from bench import run  # noqa: E402


def controls(bits) -> dict:
    """The controls of a mix with ``bits``-bit features (None: float32),
    as keyword arguments of the reference: the nearest precision below the
    stated one, and for 8 bits also the float32 arithmetic below it."""
    if not bits:
        return {"tf32": {"precision": "tf32"}}
    return {f"bits{bits // 2}": {"quant_bits": bits // 2},
            "tf32": {"quant_bits": bits, "precision": "tf32"}}


def readings(manifest, cell_name, seed, device, with_control: bool,
             config=None, program=None) -> dict:
    """One seed's readings: each number's worst over the pool for the
    program, and its best over the pool for each control."""
    from repro_torch.gnn.infer import infer_logits

    cell, centry = run.find_cell(manifest, cell_name)
    cfg = config or run.load_json(run.ROOT / centry["file"])
    mix = run.load_json(run.BENCH / "traffic" / f"{cell['traffic']}.json")
    t0 = time.perf_counter()
    p = run.prepare(cfg, mix, seed, device)
    ctrl = controls(mix["quantize_bits"]) if with_control else {}
    prog = {n: [] for n in run.NUMBERS}
    scale = []   # the reference's largest and mean logit magnitude
    each = {c: {n: [] for n in run.NUMBERS} for c in ctrl}
    for i in range(len(p.pool)):
        ref = run.reference_logits(p, i)
        scale.append([float(ref.abs().max()), float(ref.abs().mean())])
        out = run.serve(p, program or infer_logits, i)
        for n, f in run.NUMBERS.items():
            prog[n].append(f(out, ref))
        del out
        for c, kw in ctrl.items():
            out = run.reference_logits(p, i, **kw)
            for n, f in run.NUMBERS.items():
                each[c][n].append(f(out, ref))
            del out
        del ref
    return {"seed": seed, "program": {n: max(v) for n, v in prog.items()},
            "program_each": prog,
            "controls": {c: {n: min(v) for n, v in d.items()}
                         for c, d in each.items()},
            "controls_each": each, "ref_max_mean_each": scale,
            "seconds": time.perf_counter() - t0,
            "live_slots": p.graph.stats["live_slots"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    run._setup_env()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    manifest = run.load_json(run.ROOT / "BENCHMARK.json")
    lows, highs = {}, {}
    for k, seed in enumerate(args.seeds):
        r = readings(manifest, args.workload, seed, torch.device("cuda", 0),
                     k < args.control_seeds)
        for n, v in r["program"].items():
            lows[n] = max(lows.get(n, v), v)
        for c, d in r["controls"].items():
            h = highs.setdefault(c, {})
            for n, v in d.items():
                h[n] = min(h.get(n, v), v)
        print(json.dumps({"workload": args.workload, **r}), flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds),
                      "lower": lows, "upper": highs,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
