"""End-to-end GNN example of the port (the paper's evaluation protocol, §4):

  1. train GCN + GraphSAGE with the exact aggregation (ideal accuracy),
  2. inference with AES-SpMM / ES-SpMM (AFS, SFS) across W,
  3. INT8-quantized features on top of AES,
  4. strategy="auto": repro_torch.tuning picks the config per graph and
     serves later aggregations from the cached sampled plan.

    PYTHONPATH=src python -m repro_torch.examples.gnn_inference [dataset] [scale] [--device cuda|cpu]

Everything runs on ``--device`` (default ``cuda``).
"""
from __future__ import annotations

import argparse

from repro_torch._device import resolve_device
from repro_torch.gnn import evaluate, make_dataset, train_model
from repro_torch.tuning import PlanCache

WIDTHS = (8, 16, 64, 128)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dataset", nargs="?", default="ogbn-proteins")
    ap.add_argument("scale", nargs="?", type=float, default=0.004)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ds = make_dataset(args.dataset, scale=args.scale, seed=1, device=device)
    print(f"{args.dataset}: {ds.csr.num_rows} nodes, {ds.csr.nnz} edges "
          f"(scale={args.scale} of Table-2 size, on {device})\n")

    for model in ("gcn", "graphsage"):
        params, ideal = train_model(ds, model, epochs=120, seed=1,
                                    device=device)
        print(f"== {model.upper()} | ideal (exact kernel) accuracy: "
              f"{ideal:.4f}")
        print(f"{'strategy':>10} " + " ".join(f"W={w:<5}" for w in WIDTHS))
        for strat in ("aes", "afs", "sfs"):
            accs = [evaluate(ds, model, params, sh_width=w, strategy=strat,
                             device=device) for w in WIDTHS]
            print(f"{strat:>10} " + " ".join(f"{a:.4f}" for a in accs))
        q = [evaluate(ds, model, params, sh_width=w, strategy="aes",
                      quantize_bits=8, device=device) for w in WIDTHS]
        print(f"{'aes+int8':>10} " + " ".join(f"{a:.4f}" for a in q))

        cache = PlanCache()
        auto_acc = evaluate(ds, model, params, strategy="auto",
                            plan_cache=cache, device=device)
        plan = cache.plans()[0]
        print(f"{'auto':>10} {auto_acc:.4f}  "
              f"(tuned: {plan.config.key()}, cache "
              f"{cache.stats.hits} hits / {cache.stats.misses} miss)")
        # the reference's sharded-serving row (evaluate(shards=2)) comes
        # with the serving slice: the port raises on shards= until then
        print()


if __name__ == "__main__":
    main()
