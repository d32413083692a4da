"""The port's optimizers: the reference package's AdamW, its learning-rate
schedules and its int8 gradient compression with error feedback."""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.grad_compression import (compress_grads,
                                                decompress_grads)
from repro_torch.optim.schedules import constant, cosine_with_warmup

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "compress_grads", "constant", "cosine_with_warmup",
           "decompress_grads", "global_norm"]
