"""The port's optimizers: the reference package's AdamW (the learning-rate
schedules and gradient compression serve the LM pillar and come with it)."""
from repro_torch.optim.adamw import (AdamWState, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "global_norm"]
