"""Time the ELL SpMM kernel at the benchmark's graph sizes with each panel
width, for the rule that picks it (``kernels/ell_spmm.py:_panel_features``).

    python3 scripts/ell_panel_times.py [--seed N] [--cases A,B] CHECKOUT [...]

A checkout is a directory that holds ``src/repro_torch`` (this repository,
or another commit unpacked with ``git archive``); each is timed in its own
process, in the order given (name one twice, as in ``A B B A``, to see the
spread between runs of the same code).  The graphs are the benchmark's own
(``bench/gen.py`` at ``--seed``, sampled at W = 128 by the checkout's
``aes_sample``), with the operands of the benchmark's aggregations:

  * ``reddit_f602``: Reddit's layer 1, ``[232,965, 602]`` f32 features;
  * ``reddit_u8_f602``: the same quantized to uint8 (the int8 cell);
  * ``reddit_u16_f602``: the same quantized to uint16;
  * ``reddit_f64``: Reddit's layer 2 width, ``[232,965, 64]`` f32;
  * ``products_f100`` / ``products_f64``: ogbn-products' two widths over
    its 2,449,029 rows;
  * ``dataset_reddit_f128``: ``make_dataset("reddit")`` at full size and
    its 128 features, whose rows keep 7.1 live slots on average (the
    bench's Reddit about 121): the regime where a row's chain of loads,
    not bytes, bounds the gather.

Each case times the kernel at P = F (rows in row order over all of F) and
at each candidate panel width P: its own device time a launch
(``chip_smoke.kernel_own_ms``, a ``torch.profiler`` trace), the gathered
bytes over that time, the least time (``bench/counts.py``'s bytes over
3.35 TB/s) over it, and whether its output equals P = F's bit for bit;
and whether P = F's equals the plain version's bit for bit.  A checkout
without panels is timed at P = F alone.  Prints one JSON line a case and
checkout, then the card's name and power limit.  Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
W = 128
#: (case, configuration, operand width, bits of a quantized operand (0:
#: f32), candidate widths P).
CASES = (
    ("reddit_f602", "gcn-reddit", 602, 0,
     (8, 16, 24, 32, 40, 48, 64, 96, 128)),
    ("reddit_u8_f602", "gcn-reddit", 602, 8,
     (32, 64, 96, 128, 192, 256)),
    ("reddit_u16_f602", "gcn-reddit", 602, 16,
     (16, 32, 48, 64, 96, 128)),
    ("reddit_f64", "gcn-reddit", 64, 0, (16, 32)),
    ("products_f100", "graphsage-ogbn-products", 100, 0, (16, 32, 50)),
    ("products_f64", "graphsage-ogbn-products", 64, 0, (16, 32)),
    ("dataset_reddit_f128", "make_dataset:reddit", 128, 0, (16, 32, 64)),
)


def child(checkout: Path, seed: int, cases: tuple) -> None:
    sys.path.insert(0, str(checkout / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from bench import counts, gen, reference
    from repro_torch.core.graph import CSR
    from repro_torch.core.quantization import quantize
    from repro_torch.gnn import make_dataset
    from repro_torch.kernels import ell_spmm as ell_mod
    from repro_torch.kernels import ops

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    dev = torch.device("cuda")
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    panels = hasattr(ell_mod, "_launch")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in manifest["configs"]}
    for config in dict.fromkeys(c[1] for c in cases):
        if config.startswith("make_dataset:"):
            ds = make_dataset(config.split(":")[1], scale=1.0, seed=0,
                              max_avg_degree=None, device=dev)
            csr = ds.gcn_adj
            del ds
        else:
            cfg = json.loads((ROOT / files[config]).read_text())
            ref = reference.model(cfg["model"])
            g = gen.make_graph(cfg, seed, dev, self_loops=ref.SELF_LOOPS,
                               norm=ref.NORM)
            csr = CSR(g.row_ptr, g.col, g.val, int(cfg["nodes"]))
            del g
        n = csr.num_rows
        ell = ops.aes_sample(csr, W)
        live_w = ell.live_w
        live = int(live_w.sum())
        del csr
        for name, _, feat, bits, widths in (c for c in cases
                                             if c[1] == config):
            gen_ = torch.Generator(device=dev).manual_seed(seed)
            x = torch.randn((n, feat), generator=gen_, device=dev)
            meta = None
            if bits:
                qf = quantize(x, bits)
                x, meta = qf.q, (qf.scale, qf.x_min)
            item = x.element_size()
            want = ell_mod.ell_spmm_plain(ell.val, ell.col, live_w, x, meta)
            least = counts.least_s(counts.agg_bytes(n, live, feat, item),
                                   counts.agg_flops(live, feat),
                                   counts.PEAKS["H100"]) * 1e3
            rule = (ell_mod._panel_features(n, feat, item, l2)
                    if panels else feat)
            line = {"checkout": str(checkout), "case": name, "rows": n,
                    "feat": feat, "dtype": str(x.dtype), "live": live,
                    "b_mb": n * feat * item / 1e6, "l2_mb": l2 / 1e6,
                    "rule_p": rule, "least_ms": least, "p": {}}
            base = None
            for p in (feat, *widths) if panels else (feat,):
                if panels:
                    def fn(p=p):
                        return ell_mod._launch(ell.val, ell.col, live_w, x,
                                               meta, p)
                else:
                    def fn():
                        return ell_mod.ell_spmm(ell.val, ell.col, live_w, x,
                                                quantized_meta=meta)
                out = fn()
                if base is None:
                    base = out
                    line["p_f_equal_to_plain"] = bool(torch.equal(out, want))
                ms = cs.kernel_own_ms(torch, fn, "ell_spmm")[0]
                line["p"][p] = {
                    "ms": ms, "panel_mb": n * p * item / 1e6,
                    "gathered_tb_s": live * feat * item / ms / 1e9,
                    "share_of_least": least / ms,
                    "equal_to_p_f": bool(torch.equal(out, base))}
                del out
            print(json.dumps(line), flush=True)
            del x, want, base
        del ell, live_w
        torch.cuda.empty_cache()


def main(argv) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=2400000011)
    names = [c[0] for c in CASES]
    ap.add_argument("--cases", default=",".join(names),
                    help=f"comma-separated cases to time, of {names}")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("checkouts", nargs="+")
    args = ap.parse_args(argv)
    cases = args.cases.split(",")
    if set(cases) - set(names):
        ap.error(f"unknown cases {sorted(set(cases) - set(names))}")
    if args.child:
        child(Path(args.checkouts[0]).resolve(), args.seed,
              tuple(c for c in CASES if c[0] in cases))
        return
    for checkout in args.checkouts:
        run = subprocess.run([sys.executable, __file__, "--child",
                              "--seed", str(args.seed),
                              "--cases", args.cases, checkout],
                             capture_output=True, text=True)
        sys.stdout.write(run.stdout)
        if run.returncode != 0:
            sys.stderr.write(run.stderr)
            raise SystemExit(f"{checkout}: exit {run.returncode}")
        sys.stdout.flush()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
