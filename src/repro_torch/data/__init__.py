"""Token data for LM training: the deterministic, host-sharded pipeline."""
from repro_torch.data.pipeline import (PipelineConfig, TokenPipeline,
                                      make_pipeline)

__all__ = ["PipelineConfig", "TokenPipeline", "make_pipeline"]
