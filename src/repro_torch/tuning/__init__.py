"""``repro_torch.tuning`` — auto-tuning + plan cache for AES-SpMM, the
port of the reference package's ``repro.tuning``.

The paper's knobs (sampling ``strategy``, width ``W``, execution
``backend``, feature ``quant_bits``) are picked *per graph* and the result
cached, so repeated inference over the same graph never re-samples or
re-quantizes.  What ``aes_spmm(csr, x, strategy="auto")`` does:

1. **features.py** — fingerprint the CSR (blake2b over per-row-block
   digests of the raw arrays, the same hex key as the reference package)
   and extract sparsity statistics in one O(nnz) host pass.
2. **cost_model.py** — rank the candidate grid (strategy x W x backend x
   quant) analytically, roofline-style, with an accuracy proxy from edge
   coverage.
3. **measure.py** — time the analytic top-``budget`` on the live backend
   (the card synchronized around every call); the measured ordering picks
   the winner.
4. **plan_cache.py** — store the winner *with its prepared operand* as a
   ``TunedPlan`` in a bounded LRU and optionally on disk (the port's own
   ``repro_torch/`` subdirectory and schema stamp).
5. **autotune.py** — ``tune(csr, features, budget=...) -> TunedPlan``.

Blocked variant (``granularity="block"``): ``tune_blocked`` ranks
(strategy, W) per fixed-size row block, stitches the winners into a
mixed-width ``BlockELL`` served by the blocked kernel (one launch per
width bucket, the partition picked by per-bucket timings on the card), and
caches a ``BlockedPlan`` under the same fingerprint.  Layouts: natural,
degree-sorted, or auto.

Calibration (**calibration.py**): with ``$REPRO_PLAN_CACHE_DIR`` set,
every measurement appends a (roofline terms, predicted, measured) record;
once enough exist for the host, the fitted ``MachineModel`` ranks, and a
well-correlated one shrinks the measurement budget.

Incremental maintenance (**incremental.py**): ``apply_edge_updates(plan,
csr, additions, deletions)`` patches a cached ``BlockedPlan`` for an edge
delta on the CSR's device — the merge, the re-digest of touched digest
blocks, the re-ranking and re-sampling of touched plan blocks, the
re-quantization of changed feature rows — and lands bit for bit on the
plan a cold ``tune_blocked`` of the patched graph computes (``DeltaReport``
says what it touched).  The command lines come with a later slice of
the port.
"""
from repro_torch.tuning.cost_model import (CandidateConfig, CostEstimate,
                                           MachineModel, RooflineTerms,
                                           default_grid, predict, rank,
                                           roofline_terms)
from repro_torch.tuning.features import (GraphFeatures,
                                         extract_block_features,
                                         extract_features,
                                         features_from_row_nnz, fingerprint)
from repro_torch.tuning.plan_cache import (PLAN_SCHEMA_VERSION, BlockedPlan,
                                           PlanCache, TunedPlan,
                                           default_cache,
                                           features_fingerprint,
                                           normalize_shard_meta,
                                           reset_default_cache)
from repro_torch.tuning.autotune import tune, tune_blocked
from repro_torch.tuning.calibration import (CalibrationLog,
                                            calibrated_machine_model,
                                            fit_machine_model,
                                            host_fingerprint, spearman)
from repro_torch.tuning.incremental import DeltaReport, apply_edge_updates

__all__ = [
    "BlockedPlan", "CalibrationLog", "CandidateConfig", "CostEstimate",
    "DeltaReport", "GraphFeatures", "MachineModel", "PLAN_SCHEMA_VERSION",
    "PlanCache", "RooflineTerms", "TunedPlan", "apply_edge_updates",
    "calibrated_machine_model", "default_cache", "default_grid",
    "extract_block_features", "extract_features", "features_fingerprint",
    "features_from_row_nnz", "fingerprint", "fit_machine_model",
    "host_fingerprint", "normalize_shard_meta", "predict", "rank",
    "reset_default_cache", "roofline_terms", "spearman", "tune",
    "tune_blocked",
]
