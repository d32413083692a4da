"""LM pillar of the port: blocks and assembly for every architecture
(dense, sliding window, MoE, MLA, frontend stubs, Mamba2, mLSTM/sLSTM,
Zamba2's shared attention), and the training loss."""
from repro_torch.models.lm import (LM, decode_step, forward, init_cache,
                                   init_params, input_specs, loss_fn)

__all__ = ["LM", "decode_step", "forward", "init_cache", "init_params",
           "input_specs", "loss_fn"]
