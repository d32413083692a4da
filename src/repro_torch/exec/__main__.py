"""CLI smoke for the unified executor: fused-layer vs unfused parity.

    python -m repro_torch.exec --smoke [--device cpu]

Builds a small power-law graph on the fly (no dataset download), samples
it with the AES sampler (``aes_sample`` on the card), runs a 2-layer GCN
forward once through the fused layer kernel (``fused_layer``) and once
through the unfused pipeline (executor ``run_ell`` — eager ``torch``, and
``cuda``, the ``ell_spmm`` kernel — then matmul, bias and ReLU), and
asserts:

  * float parity within float32 tolerance, fused vs unfused, both
    layers;
  * quantized parity: the fused int8 gather against the
    dequantize-then-layer ``torch`` path;
  * the hidden-layer range guard: an activation outside the stored
    quantization range serves the float path bit-identically (never the
    clipped int8 re-encode).

Everything runs on ``--device`` (default ``cuda``; without a card that
raises).  On CPU tensors the kernel wrappers run their plain versions.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def _random_csr(rng, num_nodes: int, avg_deg: float, device=None):
    """A power-law CSR from ``rng``'s draws (the reference package's), on
    ``device``."""
    from repro_torch.core.graph import csr_from_edges

    deg = np.maximum(
        (rng.pareto(1.1, num_nodes) + 0.2) * avg_deg, 1).astype(np.int64)
    deg = np.minimum(deg, num_nodes)
    src = np.concatenate([rng.integers(0, num_nodes, d) for d in deg])
    dst = np.repeat(np.arange(num_nodes), deg)
    val = rng.normal(size=len(src)).astype(np.float32)
    return csr_from_edges(src, dst, num_nodes, val, device=device)


def _smoke(as_json: bool, device) -> dict:
    import torch

    from repro_torch.core.aes_spmm import sample
    from repro_torch.core.quantization import quantize
    from repro_torch.exec import default_executor

    rng = np.random.default_rng(0)
    nodes, feat, hidden, out_dim, width = 96, 24, 12, 7, 8
    csr = _random_csr(rng, nodes, 5.0, device)

    def draw(*shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(device)

    x = draw(nodes, feat)
    w1, b1 = draw(feat, hidden), draw(hidden)
    w2, b2 = draw(hidden, out_dim), draw(out_dim)

    executor = default_executor()
    ell = sample(csr, width, "aes", backend="cuda")

    def unfused(b, w, bias, relu, backend):
        h = executor.run_ell(ell, b, backend=backend) @ w + bias
        return torch.relu(h) if relu else h

    def fused(b, w, bias, relu, **kw):
        return executor.run_fused_layer(ell, b, w, bias, relu=relu,
                                        backend="cuda", **kw)

    report = {"nodes": nodes, "feat": feat, "width": width}

    # float parity, both layers, fused kernel vs unfused torch and cuda
    errs = []
    for backend in ("torch", "cuda"):
        h_ref = unfused(x, w1, b1, True, backend)
        o_ref = unfused(h_ref, w2, b2, False, backend)
        h = fused(x, w1, b1, True)
        o = fused(h, w2, b2, False)
        errs.append(float((o - o_ref).abs().max()))
    report["float_max_err"] = max(errs)
    assert report["float_max_err"] < 1e-3, \
        f"fused/unfused float divergence {report['float_max_err']}"

    # quantized parity: fused int8 gather vs dequantize-then-layer
    qf = quantize(x, 8)
    got = fused(x, w1, b1, True, quantized=qf, requant_guard=True)
    want = executor.run_fused_layer(ell, x, w1, b1, relu=True,
                                    backend="torch", quantized=qf)
    qerr = float((got - want).abs().max())
    report["quant_max_err"] = qerr
    assert qerr < 1e-3, f"quantized fused/oracle divergence {qerr}"

    # range guard: an out-of-range activation must serve the float path
    drifted = x * 10.0
    guarded = fused(drifted, w1, b1, True, quantized=qf, requant_guard=True)
    float_path = fused(drifted, w1, b1, True)
    gerr = float((guarded - float_path).abs().max())
    report["drift_guard_err"] = gerr
    assert gerr == 0.0, f"range guard served a clipped operand (err {gerr})"

    print(json.dumps(report, indent=None if as_json else 2))
    print("smoke: OK")
    return report


def main(argv=None) -> None:
    from repro_torch._device import resolve_device

    p = argparse.ArgumentParser(
        prog="python -m repro_torch.exec",
        description="Unified PlanExecutor utilities.")
    p.add_argument("--smoke", action="store_true",
                   help="fused vs unfused layer parity (CI gate)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--json", action="store_true",
                   help="single-line JSON output")
    args = p.parse_args(argv)
    if not args.smoke:
        p.error("nothing to do (pass --smoke)")
    _smoke(args.json, resolve_device(args.device))


if __name__ == "__main__":
    main()
