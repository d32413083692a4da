"""LM pillar of the port: blocks and assembly for the uniform
architectures (dense, sliding window, MoE, MLA, frontend stubs)."""
from repro_torch.models.lm import (LM, decode_step, forward, init_cache,
                                   init_params, input_specs)

__all__ = ["LM", "decode_step", "forward", "init_cache", "init_params",
           "input_specs"]
