"""Time the dequantization kernel of one or more checkouts on one card,
each in its own process, in the order given (name one twice, as in ``A B B
A``, to see the spread between runs of the same code).

    python3 scripts/dequant_times.py CHECKOUT [CHECKOUT ...]

A checkout is a directory that holds ``src/repro_torch`` (this repository,
or another commit unpacked with ``git archive``).  Each is timed with this
script's own measurement (``chip_smoke.py``'s helpers beside it), on
reddit at full size as ``chip_smoke.py`` builds it:

  * ``u8`` / ``u16``: the features ``[232,965, 128]`` quantized to uint8
    and uint16, dequantized with the constants and the output made once;
  * ``stack``: the int8 resident operand of a 4-shard spmd pass (each
    shard's gathered features quantized with its own range, stacked in
    rows of the widest shard's column count), dequantized as that
    checkout's ``GNNServer(mode="spmd")`` does it: one call over the stack
    with ``[4]`` tables where its wrapper takes them, else one call a shard
    into the slices of one output.

Each case gives the kernel's own device time (a ``torch.profiler`` trace;
``ms`` a call, ``launches`` a call), the CUDA-event time of its calls, the
host time a call and the bytes bound over 3.35 TB/s; ``u8`` and ``u16``
also the own time of ``out.copy_(q)``, PyTorch's conversion kernel over
the same bytes (no Eq. 2: what a library kernel reaches on this
traffic).  Prints one JSON line
a checkout, then the card's name and power limit.  Needs one CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHARDS = 4


def child(checkout: Path) -> dict:
    sys.path.insert(0, str(checkout / "src"))
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.core.quantization import quantize
    from repro_torch.gnn import make_dataset
    from repro_torch.kernels import dequant as dequant_mod
    from repro_torch.kernels import ops
    from repro_torch.serving import partition_csr

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card")
    dev = torch.device("cuda")
    ds = make_dataset("reddit", scale=1.0, seed=0, max_avg_degree=None,
                      device=dev)
    x = ds.features

    def case(calls, q):
        """``calls`` (one call: a list of wrapper calls) timed; ``q`` the
        whole input, for the bound."""
        def fn():
            for c in calls:
                c()
        n = q.numel()
        t_bound = cs.bound(n * (q.element_size() + 4), 2.0 * n)[0]
        ms, how, count = cs.kernel_own_ms(torch, fn, cs.DEQUANT_KERNEL)
        # a graph's replay times whole calls; a trace, each launch
        launches = count / cs.TIMING_BATCH if how == "profiler" else None
        ms *= launches or 1
        return {"ms": ms, "ms_from": how, "launches": launches,
                "events_ms": cs.time_ms(torch, fn),
                "host_ms": cs.host_ms(torch, fn), "bound_ms": t_bound,
                "share_of_bound": t_bound / ms}

    out = {"checkout": str(checkout)}
    for bits in (8, 16):
        qf = quantize(x, bits)
        q, scale, x_min = qf.q, qf.scale, qf.x_min
        dst = torch.empty(q.shape, dtype=torch.float32, device=dev)
        call = (lambda q=q, s=scale, m=x_min, b=bits:
                ops.dequantize(q, s, m, bits=b, out=dst))
        call()
        if not torch.equal(dst, dequant_mod.dequantize_plain(q, scale,
                                                             x_min)):
            raise AssertionError(f"u{bits} differs from the plain version")
        out[f"u{bits}"] = case([call], q)
        # the same bytes through PyTorch's own conversion kernel (no Eq. 2)
        out[f"u{bits}"]["convert_ms"] = cs.kernel_own_ms(
            torch, lambda q=q: dst.copy_(q), "elementwise_kernel")[0]

    shards = partition_csr(ds.gcn_adj, SHARDS)
    gcap = max(s.csr.num_cols for s in shards)
    qs = [quantize(x.index_select(0, torch.as_tensor(
        s.gather_index, device=dev)), 8) for s in shards]
    stack = torch.zeros((SHARDS * gcap, x.shape[1]), dtype=torch.uint8,
                        device=dev)
    for s, qf in enumerate(qs):
        stack[s * gcap:s * gcap + qf.q.shape[0]] = qf.q
    scale = torch.stack([qf.scale for qf in qs])
    x_min = torch.stack([qf.x_min for qf in qs])
    dst = torch.empty(stack.shape, dtype=torch.float32, device=dev)
    try:
        ops.dequantize(stack[:SHARDS], scale, x_min, bits=8)
        tables = True
    except ValueError:                  # a wrapper that takes scalars only
        tables = False
    if tables:
        calls = [lambda: ops.dequantize(stack, scale, x_min, bits=8,
                                        out=dst)]
    else:
        calls = [lambda s=s: ops.dequantize(
            stack[s * gcap:(s + 1) * gcap], scale[s], x_min[s], bits=8,
            out=dst[s * gcap:(s + 1) * gcap]) for s in range(SHARDS)]
    for c in calls:
        c()
    want = dequant_mod.dequantize_plain(
        stack.view(SHARDS, gcap, -1)[0], scale[0], x_min[0])
    if not torch.equal(dst[:gcap], want):
        raise AssertionError("the stack's first shard differs from the "
                             "plain version")
    out["stack"] = {"rows": SHARDS * gcap, "f": x.shape[1],
                    "one_call_with_tables": tables, **case(calls, stack)}
    return out


def main(argv) -> None:
    if len(argv) == 2 and argv[0] == "--child":
        print(json.dumps(child(Path(argv[1]).resolve())), flush=True)
        return
    if not argv:
        raise SystemExit(__doc__)
    for checkout in argv:
        run = subprocess.run([sys.executable, __file__, "--child", checkout],
                             capture_output=True, text=True)
        if run.returncode != 0:
            sys.stderr.write(run.stderr)
            raise SystemExit(f"{checkout}: exit {run.returncode}")
        print(run.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
