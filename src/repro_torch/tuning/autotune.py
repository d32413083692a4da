"""The tuner's entry points: ``tune(csr, features) -> TunedPlan`` (one global
config) and ``tune_blocked(csr, features) -> BlockedPlan`` (per-row-block
configs stitched into a mixed-width BlockELL).

Pipeline (one cache miss):

  1. fingerprint + sparsity features (features.py, one O(nnz) host pass;
     per block for ``tune_blocked``);
  2. analytic ranking of the candidate grid (cost_model.py);
  3. empirical refinement: measure the analytic top-``budget`` on the live
     backend (measure.py) and take the measured-fastest (``tune`` only —
     blocked tuning ranks each block analytically and measures the stitched
     plan once);
  4. prepare the plan operand — sample the ELL/BlockELL once, pre-quantize
     if the winning config asks for it — and store it in the plan cache.

Every subsequent call with the same graph is a cache hit: no sampling, no
quantization, no measurement — just the SpMM over the cached operand.

Calibration (``repro_torch.tuning.calibration``): with an active log every
measurement in step 3 appends a (predicted, measured) record; once enough
exist for this host, step 2 ranks with the *fitted* ``MachineModel`` and —
when that model's recent rank correlation is high — step 3 measures fewer
candidates (``effective_budget``).

Candidate backends are ``"torch"`` (eager) and ``"cuda"`` (the kernels),
the latter offered only when the CSR lies on a CUDA device.  The command
line over both tuners (``python -m repro.tuning.autotune`` in the reference
package) comes with the serving slice of the port.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.graph import CSR
from repro_torch.tuning import calibration, cost_model, measure
from repro_torch.tuning import features as features_mod
from repro_torch.tuning.cost_model import (CandidateConfig, DEFAULT_WIDTHS,
                                           MachineModel, default_grid)
from repro_torch.tuning.plan_cache import (BlockedPlan, PlanCache, TunedPlan,
                                           default_cache,
                                           features_fingerprint,
                                           normalize_shard_meta)


def _default_backends(device: torch.device) -> tuple[str, ...]:
    # the kernels run only on the card; CPU tensors take the eager path
    return ("torch", "cuda") if device.type == "cuda" else ("torch",)


def _synthetic_features(csr: CSR, seed: int) -> torch.Tensor:
    """The stand-in f32[rows, 64] operand, drawn with numpy from ``seed``
    (the reference package's draws), on the CSR's device."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(np.asarray(
        rng.normal(size=(csr.num_rows, 64)), np.float32)).to(csr.device)


def block_grid(backend, quant_bits, strategies, widths,
               include_full) -> list[CandidateConfig]:
    """The per-block candidate grid: ``strategies x widths`` (+ ``full``).
    ``tune_blocked`` and the patch path (``tuning.incremental``) both rank
    over it, so a patched block's analytic winner is the cold tune's."""
    candidates = [CandidateConfig(s, w, backend, quant_bits)
                  for s in strategies for w in widths]
    if include_full:
        candidates.append(CandidateConfig("full", 0, backend, quant_bits))
    return candidates


def _rank_blocks(csr, block_rows, feat_dim, strategies, widths,
                 include_full, backend, quant_bits, machine,
                 accuracy_weight, verbose=False, tag=""):
    """Analytic per-block ranking over one row layout: extract block
    features and pick the (strategy, W) winner per block.  Returns
    ``(block_feats, configs, predicted_us)`` — deterministic, so ranking
    the same CSR twice (e.g. both layouts of an ``layout="auto"`` tune)
    always lands on the same table."""
    block_feats = features_mod.extract_block_features(
        csr, block_rows, feat_dim=feat_dim)
    candidates = block_grid(backend, quant_bits, strategies, widths,
                            include_full)
    configs, predicted_us = [], 0.0
    for b, bf in enumerate(block_feats):
        best = cost_model.rank(bf, candidates, machine, accuracy_weight)[0]
        configs.append((best.config.strategy, best.config.sh_width))
        predicted_us += best.latency_us
        if verbose:
            print(f"  {tag}block {b:4d} rows={bf.num_rows} nnz={bf.nnz} "
                  f"max={bf.max_row_nnz} -> {best.config.key()}")
    return block_feats, configs, predicted_us


def _layout_cost(block_feats, configs, predicted_us, machine,
                 max_buckets) -> float:
    """Launch-adjusted analytic latency of one ranked layout, comparable
    across layouts before either is sampled: the per-block sum minus the
    per-kernel launch overhead the stitched plan's bucketed dispatch
    amortizes.  Bucket count is estimated from the *approximate* per-block
    widths ("full" blocks priced at their max row nnz) — the stitched
    widths aren't known until sampling, but bucketing only depends on the
    width multiset, which these approximations track."""
    from repro_torch.core.graph import partition_width_buckets

    approx = [max(int(bf.max_row_nnz), 1) if s == "full" else max(int(w), 1)
              for bf, (s, w) in zip(block_feats, configs)]
    buckets = partition_width_buckets(tuple(approx), max_buckets)
    return predicted_us - (len(block_feats) - max(len(buckets), 1)) \
        * machine.launch_overhead_us


@obs.traced("tune", granularity="graph")
def tune(csr: CSR, features=None, *, budget: int = 6,
         widths: Sequence[int] = DEFAULT_WIDTHS,
         backends: Sequence[str] | None = None,
         quant: Sequence[Optional[int]] = (None,),
         grid: Sequence[CandidateConfig] | None = None,
         machine: MachineModel | None = None,
         accuracy_weight: float = 5.0,
         cache: PlanCache | None = None,
         warmup: int = 1, iters: int = 3,
         shard_meta=None, refresh: bool = False,
         seed: int = 0,
         verbose: bool = False) -> TunedPlan:
    """Pick (strategy, W, backend, quant) for ``csr`` and cache the plan.

    ``budget`` bounds how many candidates are *measured* (the whole grid is
    always ranked analytically first).  ``features`` is the dense operand the
    SpMM will multiply; when omitted a synthetic f32[rows, 64] drawn with
    ``seed`` stands in (timings stay representative because cost scales
    linearly in feat_dim — and a fixed seed keeps repeated tunes, and the
    calibration records they log, byte-reproducible).
    ``machine=None`` ranks with the host-calibrated ``MachineModel`` when
    enough (predicted, measured) pairs have been logged
    (``repro_torch.tuning.calibration``); a trustworthy calibrated model also
    *shrinks* the measurement budget (``calibration.effective_budget``).
    ``shard_meta=(mesh_shape, shard_idx, num_shards)`` marks the plan as a
    per-shard serving plan — it is cached under the extended key
    ``(fingerprint, kind, shard_meta)`` so it never collides with the
    whole-graph plan of the same CSR content.  ``backends`` defaults to
    ``("torch", "cuda")`` for a CSR on the card and ``("torch",)`` on the
    CPU.
    ``refresh=True`` forces a re-tune: the cache read is skipped but the
    fresh plan still overwrites the entry.
    """
    cache = cache if cache is not None else default_cache()
    shard_meta = normalize_shard_meta(shard_meta)
    fp = features_mod.fingerprint(csr)
    plan = None if refresh else cache.get(fp, shard_meta=shard_meta,
                                          device=csr.device)
    if plan is not None:
        return plan

    from repro_torch.core.quantization import QuantizedFeatures, dequantize

    if isinstance(features, QuantizedFeatures):
        # global tuning works on the dense operand; a pre-quantized input
        # stands for its Eq. 2 reconstruction (quantized candidates
        # re-derive the same levels from it)
        features = dequantize(features)
    synthetic_features = features is None
    if synthetic_features:
        features = _synthetic_features(csr, seed)
    feats = features_mod.extract_features(
        csr, feat_dim=int(features.shape[1]), with_fingerprint=False)

    candidates = list(grid) if grid is not None else default_grid(
        widths=widths, backends=backends or _default_backends(csr.device),
        quant=quant)
    if synthetic_features:
        # Pre-quantizing a stand-in matrix would cache an operand no real
        # feature set can ever match — quantized plans need real features.
        candidates = [c for c in candidates if c.quant_bits is None]
        if not candidates:
            raise ValueError(
                "quantized candidate grid requires the real feature matrix "
                "(pass `features=`)")
    resolved = machine if machine is not None \
        else calibration.calibrated_machine_model()
    ranked = cost_model.rank(feats, candidates, resolved, accuracy_weight)
    if verbose:
        for est in ranked:
            print("  " + est.as_row())

    # A calibrated model whose recent rank correlation on the logged pairs
    # is high has earned a smaller measurement budget (warm-log tunes
    # make fewer measure_config calls than cold-log ones).
    top_k = max(budget, 1)
    if machine is None:
        top_k = calibration.effective_budget(top_k, machine=resolved)
    measured = measure.refine(csr, features, ranked, top_k=top_k,
                              warmup=warmup, iters=iters,
                              accuracy_weight=accuracy_weight, feats=feats)
    best = measured[0]
    ell, quantized = measure.prepare_operand(csr, best.config, features)
    plan = TunedPlan(
        config=best.config, ell=ell, quantized=quantized, fingerprint=fp,
        features_fp=(features_fingerprint(features)
                     if quantized is not None else ""),
        predicted_us=best.estimate.latency_us if best.estimate else 0.0,
        measured_spmm_us=best.spmm_us, measured_sample_us=best.sample_us,
        shard_meta=shard_meta)
    # the auditable one-liner: what won, what the model predicted, what
    # the microbenchmark measured
    obs.decision("tune", granularity="graph",
                 strategy=best.config.strategy,
                 sh_width=best.config.sh_width,
                 backend=best.config.backend,
                 quant_bits=best.config.quant_bits,
                 predicted_us=round(plan.predicted_us, 2),
                 measured_us=round(plan.measured_spmm_us, 2),
                 measured_candidates=top_k)
    cache.put(plan)
    return plan


@obs.traced("tune", granularity="block")
def tune_blocked(csr: CSR, features=None, *, block_rows: int = 4096,
                 widths: Sequence[int] = DEFAULT_WIDTHS,
                 strategies: Sequence[str] = ("aes", "afs", "sfs"),
                 backend: str | None = None,
                 include_full: bool = True,
                 quant=None,
                 layout: str = "natural",
                 max_buckets: int = 3,
                 machine: MachineModel | None = None,
                 accuracy_weight: float = 5.0,
                 cache: PlanCache | None = None,
                 measure_plan: bool = True,
                 measure_buckets: bool = True,
                 warmup: int = 1, iters: int = 3,
                 shard_meta=None, refresh: bool = False,
                 seed: int = 0,
                 verbose: bool = False) -> BlockedPlan:
    """Pick (strategy, W) *per fixed-size row block* and cache the stitched
    mixed-width plan.

    Each block is ranked analytically over ``strategies x widths``
    (+ ``full``) with its own sparsity features, so a bimodal degree
    distribution gets a wide config on its dense head and a narrow one on
    its sparse tail instead of one global compromise.  Per-block
    microbenchmarks would cost ``num_blocks x budget`` timings; instead the
    empirical pass here works per *width bucket*: candidate bucket
    partitions (1..``max_buckets`` buckets over the blocks' widths) are
    each timed end-to-end on the live backend
    (``measure.measure_bucket_partition``) and the measured-fastest wins;
    the winner's launches are then timed bucket-by-bucket
    (``measure.measure_blocked_buckets``) for the plan's per-bucket
    breakdown — and the whole stitched plan once (``measure_plan``) for
    reporting.

    Args:
      csr / features: as in :func:`tune` (synthetic f32[rows, 64] stands in
        when ``features`` is omitted).  ``features`` may itself be a
        pre-quantized ``QuantizedFeatures`` — the plan then serves its
        Eq. 2 reconstruction through the fused-dequant path.
      block_rows: rows per block (4096 by default).
      widths: candidate ELL widths per block.
      strategies: sampled strategies in each block's grid.
      backend: execution backend for the whole plan ("torch" | "cuda";
        default: cuda for a CSR on the card, torch on the CPU).  Blocked plans use one
        backend — per-block backends would fragment dispatch.
      include_full: also offer exact padding (width = block max nnz) per
        block — on sparse tail blocks this is usually the winner.
      quant: quantize the features for serving — ``None`` (float), a bit
        width (8/16: the real ``features`` matrix is pre-quantized per
        Eq. 1 and cached with the plan), or a ready ``QuantizedFeatures``
        (reused as-is; shape-checked against ``features``, and trusted to
        encode that same matrix — content equality of a lossy encoding is
        unverifiable).  The cuda backend then fuses Eq. 2 into the
        B-row gather; the torch backend dequantizes up front.
      layout: row layout of the stitched operand — "natural" (node
        order), "degree_sorted" (rows stably sorted nnz-descending
        before blocking, so hub rows pack into a few wide blocks and
        per-block widths tighten; the executor restores natural order
        via an inverse-permutation output gather, so results are
        bit-identical), or "auto" (rank both layouts with the calibrated
        cost model — launch-adjusted per-block latency sums — and keep
        the cheaper; ties go to natural, which has no epilogue).  The
        layout is part of the cache key, so both layouts of one graph
        coexist; the fingerprint itself is always computed over the
        natural-order CSR.
      max_buckets: kernel-launch budget for width bucketing (cuda
        backend): blocks are grouped into at most this many width buckets,
        one launch each.
      cache: plan cache (default process-wide); blocked plans are stored
        under the same CSR fingerprint as global ones, kind="block".
      shard_meta: ``(mesh_shape, shard_idx, num_shards)`` for per-shard
        serving plans — extends the cache key so a shard's plan coexists
        with the whole-graph plan of the same CSR content.
      measure_buckets: time candidate bucket partitions on the live
        backend and pick by measurement (cuda backend only); otherwise
        the finest <= ``max_buckets`` partition is used analytically.

    Like :func:`tune`, the cache is keyed by graph content only: a warm
    cache returns the stored plan *as tuned*, and every tuning knob above
    (``block_rows``, ``widths``, ``backend``, ``quant``, ...) is ignored
    on a hit.  To re-tune with different knobs, pass ``refresh=True``
    (skips the cache read; the fresh plan still overwrites the entry) or
    evict first (``cache.clear()`` / a fresh ``PlanCache``).

    Returns the cached or freshly built :class:`BlockedPlan`.
    """
    from repro_torch.core.graph import (combine_block_digests,
                                        csr_block_digests,
                                        partition_width_buckets)
    from repro_torch.core.quantization import (QuantizedFeatures,
                                               as_quantized, dequantize)
    from repro_torch.core.sampling import sample_csr_to_block_ell

    cache = cache if cache is not None else default_cache()
    shard_meta = normalize_shard_meta(shard_meta)
    if layout not in ("natural", "degree_sorted", "auto"):
        raise ValueError(f"unknown layout {layout!r}; expected 'natural', "
                         "'degree_sorted', or 'auto'")
    # one digest pass serves both the cache key and the plan's stored
    # per-block digests (what apply_edge_updates rolls forward on a delta)
    # — always over the natural-order CSR, whatever layout wins below
    digests = csr_block_digests(csr)
    fp = combine_block_digests(digests, csr.num_rows, csr.num_cols)
    plan = None if refresh \
        else cache.get(fp, kind="block", shard_meta=shard_meta,
                       layout=layout, device=csr.device)
    if plan is not None:
        return plan

    if backend is None:
        backend = _default_backends(csr.device)[-1]

    # -- resolve the (features, quantized) pair ---------------------------
    qf = None
    if isinstance(features, QuantizedFeatures):
        qf, features = features, None
    if isinstance(quant, QuantizedFeatures):
        qf = quant
        quant_bits = qf.bits
    elif quant is not None:
        quant_bits = int(quant)
        if qf is not None and qf.bits != quant_bits:
            # explicit bit-width wins over a mismatched pre-quantized input:
            # re-encode from its Eq. 2 reconstruction
            qf = as_quantized(qf, quant_bits)
    else:
        quant_bits = qf.bits if qf is not None else None
    if features is None:
        if qf is not None:
            # serve the reconstruction the quantized operand encodes
            features = dequantize(qf)
        else:
            if quant_bits is not None:
                # mirror tune(): quantizing a synthetic stand-in would cache
                # an operand no real feature set can ever match
                raise ValueError(
                    "quantized blocked plans require the real feature "
                    "matrix (pass `features=`)")
            features = _synthetic_features(csr, seed)
    if qf is not None and features is not None \
            and tuple(qf.q.shape) != tuple(features.shape):
        # the features_fp guard hashes `features`, so a qf of another shape
        # would silently serve the wrong matrix — refuse loudly instead
        raise ValueError(
            f"quantized operand shape {tuple(qf.q.shape)} does not match "
            f"features shape {tuple(features.shape)}")
    if quant_bits is not None and qf is None:
        qf = as_quantized(features, quant_bits)
    feat_dim = int(features.shape[1])

    if machine is None:
        # resolve once — re-resolving (and memo-probing) per block would
        # stat the calibration log num_blocks times; fall back to the
        # explicit default so rank() never re-resolves either
        machine = calibration.calibrated_machine_model() or MachineModel()

    # -- resolve the row layout -------------------------------------------
    rank_kw = dict(block_rows=block_rows, feat_dim=feat_dim,
                   strategies=strategies, widths=widths,
                   include_full=include_full, backend=backend,
                   quant_bits=quant_bits, machine=machine,
                   accuracy_weight=accuracy_weight, verbose=verbose)
    perm = None
    if layout == "natural":
        block_feats, configs, predicted_us = _rank_blocks(csr, **rank_kw)
    else:
        from repro_torch.core.graph import degree_sort_permutation

        sperm, _, sorted_csr = degree_sort_permutation(csr)
        if layout == "degree_sorted":
            perm = sperm
            block_feats, configs, predicted_us = _rank_blocks(
                sorted_csr, **dict(rank_kw, tag="sorted "))
        else:   # "auto": rank both, keep the cheaper (tie -> natural)
            nat = _rank_blocks(csr, **dict(rank_kw, verbose=False))
            srt = _rank_blocks(sorted_csr,
                               **dict(rank_kw, verbose=False))
            nat_cost = _layout_cost(*nat, machine, max_buckets)
            srt_cost = _layout_cost(*srt, machine, max_buckets)
            if srt_cost < nat_cost:
                perm = sperm
                block_feats, configs, predicted_us = srt
            else:
                block_feats, configs, predicted_us = nat
            if verbose:
                print(f"  layout auto: natural={nat_cost:.1f}us "
                      f"degree_sorted={srt_cost:.1f}us -> "
                      f"{'degree_sorted' if perm is not None else 'natural'}")

    bell = sample_csr_to_block_ell(
        csr if perm is None else sorted_csr, configs, block_rows)

    # -- width buckets: candidate partitions, measured per bucket ---------
    cand_parts = []
    for k in range(1, max(int(max_buckets), 1) + 1):
        p = partition_width_buckets(bell.widths, k)
        if p not in cand_parts:
            cand_parts.append(p)
    bucket_us: tuple = ()
    if backend == "cuda" and measure_buckets and len(cand_parts) > 1:
        b_operand = qf.q if qf is not None else features
        qmeta = (qf.scale, qf.x_min) if qf is not None else None
        # selection: one end-to-end timing per candidate partition (each
        # pays its real dispatch epilogue — like vs like)
        timed = [
            (measure.measure_bucket_partition(
                bell, b_operand, p, quantized_meta=qmeta,
                warmup=warmup, iters=iters), p)
            for p in cand_parts
        ]
        _, buckets = min(timed, key=lambda t: t[0])
        # reporting: per-bucket breakdown of the winner
        bucket_us = tuple(measure.measure_blocked_buckets(
            bell, b_operand, buckets, quantized_meta=qmeta,
            warmup=warmup, iters=iters))
        if verbose:
            for us, p in timed:
                print(f"  buckets {[w for w, _ in p]} -> {us:.1f}us")
    else:
        buckets = cand_parts[-1]    # finest partition: least width spread

    # Each per-block estimate carries the per-kernel launch overhead, but
    # the stitched plan dispatches all blocks from one launch per width
    # bucket — keep the overhead once per bucket, not num_blocks times.
    predicted_us -= (len(block_feats) - max(len(buckets), 1)) \
        * machine.launch_overhead_us

    plan = BlockedPlan(bell=bell, backend=backend, fingerprint=fp,
                       quantized=qf,
                       features_fp=(features_fingerprint(features)
                                    if qf is not None else ""),
                       buckets=buckets,
                       predicted_us=predicted_us,
                       measured_bucket_us=bucket_us,
                       shard_meta=shard_meta,
                       block_digests=tuple(digests),
                       layout=layout, perm=perm)
    if measure_plan:
        plan.measured_spmm_us = measure.time_us(
            plan.run, features, warmup=warmup, iters=iters)
        _log_blocked_plan(block_feats, configs, backend, quant_bits, plan)
    if obs.enabled():
        # per-block W choices compressed to a "WxN" histogram, plus the
        # slot-vs-nnz tightness the mixed widths bought (quality counter)
        width_hist = {}
        for w in bell.widths:
            width_hist[w] = width_hist.get(w, 0) + 1
        obs.decision("tune", granularity="block", backend=backend,
                     layout=plan.row_layout,
                     quant_bits=quant_bits, num_blocks=len(block_feats),
                     widths=" ".join(f"{w}x{n}" for w, n
                                     in sorted(width_hist.items())),
                     buckets=len(buckets),
                     slots=int(bell.col.numel()), nnz=int(csr.nnz),
                     predicted_us=round(predicted_us, 2),
                     measured_us=round(plan.measured_spmm_us, 2))
    cache.put(plan)
    return plan


def _log_blocked_plan(block_feats, configs, backend, quant_bits,
                      plan) -> None:
    """One whole-plan calibration record (kind="plan"): the per-block
    roofline terms summed vs the stitched plan's measured latency.  This is
    what makes blocked tunes feed the calibration loop even on the torch
    backend, where no per-bucket measurement runs.  No-op without an active log; never raises."""
    if calibration.default_log() is None:
        return
    try:
        t_flops = t_bytes = t_slots = 0.0
        for bf, (s, w) in zip(block_feats, configs):
            t = cost_model.roofline_terms(
                bf, CandidateConfig(s, w, backend, quant_bits))
            t_flops += t.flops
            t_bytes += t.bytes
            t_slots += t.slots
        terms = cost_model.RooflineTerms(t_flops, t_bytes, t_slots)
        calibration.log_measurement(
            "plan",
            {"strategy": "block", "sh_width": 0, "backend": backend,
             "quant_bits": quant_bits},
            terms, plan.predicted_us, plan.measured_spmm_us,
            {"num_rows": plan.bell.num_rows,
             "num_blocks": plan.bell.num_blocks,
             "feat_dim": block_feats[0].feat_dim if block_feats else 0})
    except Exception:
        pass
