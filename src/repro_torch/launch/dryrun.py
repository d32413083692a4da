"""Dry run over the production meshes: every (architecture x input shape)
cell's step run once on the rank-0 shard of a fake 256- or 512-rank
process group, with per-device memory, flops and collectives recorded.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \
        --shape train_4k [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

Artifacts: artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json

Where the reference lowers and compiles each cell with XLA on 512 forced
host devices, the port runs it eagerly: a fake process group
(``FakeStore``: collectives complete at once and move no data), the
model built full size under ``FakeTensorMode`` (shapes, no storage), the
parameters, AdamW state, batch and cache placed by
``distributed.sharding``'s rules as DTensors of rank 0's blocks, and the
step (train: loss, gradients, AdamW; prefill; decode) run once under
``implicit_replication``.  Each cell records

- ``memory.argument_bytes``: the local bytes of every input;
- ``memory.peak_bytes``: the eager peak of rank 0's live storage bytes,
  counted as ``MemTracker`` counts them (:class:`_RankOps`),
  ``fits_h100``, and ``peak_held_by``: the ops whose outputs hold the
  most of it;
- ``flops_per_device``: the products rank 0 runs, counted by
  ``FlopCounterMode``'s rules (for train cells beside 6 N tokens /
  ranks);
- ``collective_bytes_per_device``: each collective's result bytes by
  kind, with ``counts`` (``CommDebugMode``), the reference's convention;
- ``bytes_accessed_per_device``: null (XLA's cost analysis has no eager
  counterpart);
- ``registered_strategies``: ``sharding.DTENSOR_REWRITES``.

The eager step materializes what XLA would fuse away (attention scores
at S = 32,768 above all), so its peak is an upper bound, not XLA's.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch._device import resolve_device
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config
from repro_torch.distributed.sharding import (DTENSOR_REWRITES, axis_names,
                                              axis_sizes, batch_shardings,
                                              cache_shardings,
                                              param_shardings, place,
                                              scalar_sharding, shard_bytes,
                                              tree_leaves, zip_map)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train import state_shardings, value_and_grad
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, input_specs)
from repro_torch.optim import adamw_init, adamw_update

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
#: one H100 SXM's device memory (datasheet), bytes
H100_HBM_BYTES = 80e9
#: the ops whose outputs hold the most of the peak, recorded a cell
PEAK_OPS = 5

#: functional collective (by op name) -> the reference's kind
_KINDS = (("all_gather", "all-gather"), ("reduce_scatter", "reduce-scatter"),
          ("all_reduce", "all-reduce"), ("all_to_all", "all-to-all"),
          ("broadcast", "broadcast"))


def _kind(func) -> str | None:
    packet = getattr(func, "_overloadpacket", None)
    name = getattr(packet, "__name__", "")
    return next((kind for key, kind in _KINDS if key in name), None)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _comm_mode():
    """``CommDebugMode`` that also sums each collective's result bytes by
    kind."""
    from torch.distributed.tensor.debug import CommDebugMode

    class CommBytes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.result_bytes: dict = defaultdict(int)
            self.kind_counts: dict = defaultdict(int)

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            kind = _kind(func)
            if kind is not None and out is not NotImplemented:
                self.result_bytes[kind] += sum(
                    _nbytes(t) for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor))
                self.kind_counts[kind] += 1
            return out

    return CommBytes()


class _RankOps(TorchDispatchMode):
    """Rank 0's ops, the top mode of the step.  DTensor ops are left to
    desugar into the ops on local blocks (as ``CommDebugMode`` does); the
    ops that DTensor's sharding propagation runs on global shapes, under
    a fake mode of its own, are told apart by that mode and left out.  Of
    rank 0's ops it keeps

    - the products' flops, by ``FlopCounterMode``'s rules;
    - the live storage bytes and their peak: each new storage counted at
      its size until it is freed, as ``MemTracker`` counts (which, in the
      torch 2.11 of the machine with the card, also counts the
      propagation's global-shape tensors, and rounds a CUDA storage to
      the allocator's 512-byte blocks: a run on the card and one on the
      CPU would disagree), and at the peak the live bytes by the op that
      made them (``"input"`` for the step's arguments);

    and it keeps the collectives' aliases as eager ones are: a
    ``wait_tensor`` on a fake tensor is answered with its argument, and
    the output of ``_wrap_tensor_autograd`` (which eagerly wraps its
    input) is counted as its input's storage, kept live with it; the fake
    kernels of both make a new tensor."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode
        from torch.utils.weak import WeakIdKeyDictionary

        self.rules = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.live_bytes = self.peak_bytes = 0
        self.live_by_op: dict = defaultdict(int)
        self.peak_by_op: dict = {}
        self._storages = WeakIdKeyDictionary()
        self._aliases = WeakIdKeyDictionary()
        self.mode = None

    def track(self, tensor, op: str = "input") -> None:
        """Counts ``tensor``'s storage, made by ``op``, as live until it
        is freed."""
        import weakref

        if not isinstance(tensor, torch.Tensor):
            return
        st = tensor.untyped_storage()
        if st in self._storages or st in self._aliases:
            return
        n = st.nbytes()
        self._storages[st] = n
        weakref.finalize(st, self._free, n, op)
        self.live_bytes += n
        self.live_by_op[op] += n
        if self.live_bytes > self.peak_bytes:
            self.peak_bytes = self.live_bytes
            self.peak_by_op = dict(self.live_by_op)

    def _free(self, n: int, op: str) -> None:
        self.live_bytes -= n
        self.live_by_op[op] -= n

    def __enter__(self):
        from torch._guards import active_fake_mode

        self.mode = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch._subclasses.fake_tensor import is_fake
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if (func is torch.ops._c10d_functional.wait_tensor.default
                and is_fake(args[0])):
            return args[0]
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (func.name() == "_c10d_functional::_wrap_tensor_autograd"
                and is_fake(args[0])):
            self._aliases[out.untyped_storage()] = args[0]
            return out
        if active_fake_mode() is self.mode:
            rule = self.rules.get(getattr(func, "_overloadpacket", None))
            if rule is not None:
                self.flops += rule(*args, **kwargs, out_val=out)
            for t in tree_leaves(out):
                self.track(t, str(func))
        return out


@contextmanager
def fake_group(ranks: int):
    """A fake default process group of ``ranks`` ranks, this process rank
    0 (collectives complete at once and move nothing), destroyed on
    exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run starts its own fake process group; "
                           "a default group exists already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _materialize(specs: dict, device) -> dict:
    """Tensors (fake, under the caller's ``FakeTensorMode``) for
    ``input_specs``' ``meta`` stand-ins."""
    return {k: torch.zeros(v.shape, dtype=v.dtype, device=device)
            for k, v in specs.items()}


def build_cell(arch: str, shape: str, mesh, aes_kv=None, options=None,
               dp_over_model: bool = False, zero1: bool = False,
               cache_heads: bool = False, donate_cache: bool = False,
               device=None):
    """Returns (step, args, specs) for one cell, built under the caller's
    ``FakeTensorMode`` on ``device`` (``mesh`` may be abstract where the
    step is not run): ``step(*placed_args)`` runs the
    cell's step once, ``args`` are its inputs at full size and ``specs``
    their partition specs by the rules.  ``aes_kv``: AES-KV sampled
    decode; ``options``: ArchConfig overrides (kv_quant_bits,
    remat_policy, bf16_logits, ...); ``dp_over_model``: the batch over
    every mesh axis; ``zero1``: ZeRO-1 moments.  ``donate_cache`` is the
    reference's buffer donation: the port's decode writes its cache in
    place whatever it is."""
    del donate_cache
    from torch.func import functional_call

    cfg = get_config(arch)
    if aes_kv:
        cfg = cfg.with_aes_kv(aes_kv)
    if options:
        cfg = cfg.with_options(**options)
    seq, batch, kind = SHAPES[shape]
    specs_in = input_specs(cfg, kind, seq, batch)
    model = init_params(cfg, 0, device=device)
    params = {k: p.detach() for k, p in model.named_parameters()}

    def batch_specs(tree):
        if not dp_over_model:
            return batch_shardings(mesh, tree)
        every = axis_names(mesh)
        size = math.prod(axis_sizes(mesh).values())
        return {k: ((every if v.ndim and v.shape[0] % size == 0 else None),)
                + (None,) * (v.ndim - 1) for k, v in tree.items()}

    if kind == "train":
        opt = adamw_init(params)
        toks = _materialize(specs_in, device)
        p_specs, o_specs = state_shardings(mesh, (params, opt), zero1=zero1)

        def train_step(params, opt, toks):
            loss, grads = value_and_grad(model, cfg, params, toks)
            params, opt = adamw_update(grads, opt, params, lr=1e-4,
                                       weight_decay=0.1)
            return params, opt, loss

        return (train_step, (params, opt, toks),
                (p_specs, o_specs, batch_specs(toks)))

    p_specs = param_shardings(mesh, params)

    if kind == "prefill":
        toks = _materialize(specs_in, device)

        def prefill_step(params, toks):
            with torch.no_grad():
                logits, _, cache = functional_call(
                    model, params, (forward, cfg),
                    dict(tokens=toks.get("tokens"), embeds=toks.get("embeds"),
                         want_cache=True, remat=False))
            return logits, cache

        return prefill_step, (params, toks), (p_specs, batch_specs(toks))

    # decode: the step writes position seq - 1 of a full-length cache
    cache = init_cache(cfg, batch, seq, device=device)
    specs_in.pop("cache")
    cache_len = _materialize({"cache_len": specs_in.pop("cache_len")},
                             device)
    toks = _materialize(specs_in, device)

    def serve_step(params, cache, toks, cache_len_):
        with torch.no_grad():
            return functional_call(
                model, params, (decode_step, cfg, cache),
                dict(tokens=toks.get("tokens"), embeds=toks.get("embeds"),
                     cache_len=seq - 1))

    c_specs = cache_shardings(mesh, cache, stacked=cfg.block_pattern is None,
                              prefer_heads=cache_heads)
    return (serve_step, (params, cache, toks, cache_len),
            (p_specs, c_specs, batch_specs(toks),
             {"cache_len": scalar_sharding(mesh)}))


def argument_bytes(args, specs, mesh) -> int:
    """One device's bytes of a cell's inputs under their specs (no
    placement needed: ``mesh`` may be abstract)."""
    sizes = []
    zip_map(lambda t, spec: sizes.append(shard_bytes(t, spec, mesh)), args,
            specs)
    return sum(sizes)


def run_cell(arch: str, shape: str, multi_pod: bool, save: bool = True,
             verbose: bool = True, variant: str = "", device=None,
             **cell_kw) -> dict:
    """One cell on the rank-0 shard of a fake 256- or 512-rank group; the
    result as the JSON records it (``status`` OK, FAIL with the error and
    traceback, or SKIP)."""
    device = resolve_device(device)
    cfg = get_config(arch)
    seq, batch, kind = SHAPES[shape]
    ranks = 512 if multi_pod else 256
    result = {"arch": arch, "shape": shape,
              "mesh": "2x16x16" if multi_pod else "16x16", "kind": kind,
              "seq": seq, "batch": batch, "ranks": ranks,
              "device": device.type}
    if variant:
        result["variant"] = variant

    if shape == "long_500k" and not cfg.sub_quadratic:
        result["status"] = "SKIP"
        result["reason"] = ("pure full attention — quadratic long-context "
                            "decode out of spec (DESIGN.md §4)")
        _finish(result, save, verbose)
        return result

    t0 = time.time()
    try:
        with fake_group(ranks):
            mesh = make_production_mesh(multi_pod=multi_pod, device=device)
            result.update(_run(mesh, arch, shape, kind, device, cell_kw, t0))
        if kind == "train":
            result["model_flops_per_device"] = (
                6 * cfg.param_count_dense() * seq * batch / ranks)
    except Exception as e:  # noqa: BLE001 — a failed cell is a recorded bug
        result["status"] = "FAIL"
        result["error"] = f"{type(e).__name__}: {e}"[:2000]
        result["traceback"] = traceback.format_exc()[-4000:]
    _finish(result, save, verbose)
    return result


def _run(mesh, arch, shape, kind, device, cell_kw, t0) -> dict:
    """The cell's step once on ``mesh``: its measurements."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args, specs = build_cell(arch, shape, mesh, device=device,
                                       **cell_kw)
        placed = place(args, specs, mesh)
        del args
    # the step runs with the fake mode off: a tensor the model makes is
    # real (small: positions, masks) and turns fake where it meets a fake
    # one, and the modes below tell rank 0's ops from the global-shape
    # ops of DTensor's sharding propagation, which enters a fake mode of
    # its own
    t_build = time.time() - t0
    local = [leaf.to_local() for leaf in tree_leaves(placed)]
    comm, ops = _comm_mode(), _RankOps()
    for t in local:
        ops.track(t)
    with comm, ops, implicit_replication():
        step(*placed)
    t_step = time.time() - t0 - t_build
    argument_bytes = sum(_nbytes(t) for t in local)
    coll = dict(comm.result_bytes)
    coll["total"] = sum(comm.result_bytes.values())
    coll["counts"] = dict(comm.kind_counts)
    return {"status": "OK",
            "build_s": round(t_build, 1),
            "step_s": round(t_step, 1),
            "flops_per_device": ops.flops,
            "bytes_accessed_per_device": None,
            "bytes_accessed_reason": (
                "XLA's cost analysis has no counterpart for an eager step"),
            "collective_bytes_per_device": coll,
            "memory": {"argument_bytes": argument_bytes,
                       "peak_bytes": ops.peak_bytes,
                       "fits_h100": ops.peak_bytes <= H100_HBM_BYTES,
                       "peak_held_by": sorted(
                           ([op, n] for op, n in ops.peak_by_op.items() if n),
                           key=lambda e: -e[1])[:PEAK_OPS]},
            "registered_strategies": list(DTENSOR_REWRITES)}


def _finish(result, save, verbose):
    if save:
        ART.mkdir(parents=True, exist_ok=True)
        v = f"__{result['variant']}" if result.get("variant") else ""
        name = f"{result['arch']}__{result['shape']}__{result['mesh']}{v}.json"
        (ART / name).write_text(json.dumps(result, indent=1, default=str))
    if verbose:
        s = result["status"]
        extra = ""
        if s == "OK":
            extra = (f" flops/dev={result['flops_per_device']:.3e}"
                     f" coll={result['collective_bytes_per_device']['total']:.3e}B"
                     f" peak={result['memory']['peak_bytes']:.3e}B"
                     f" step={result['step_s']}s")
        elif s == "FAIL":
            extra = " " + result["error"].splitlines()[0][:160]
        print(f"[dryrun] {result['arch']}/{result['shape']}/{result['mesh']}"
              f": {s}{extra}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    archs = ALL_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                r = run_cell(arch, shape, mp, device=args.device)
                n_fail += r["status"] == "FAIL"
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
