"""Atomic, async, elastic checkpoints of the train state."""
from repro_torch.checkpoint.checkpointer import (Checkpointer, latest_step,
                                                 latest_steps,
                                                 restore_checkpoint,
                                                 save_checkpoint)

__all__ = ["Checkpointer", "latest_step", "latest_steps",
           "restore_checkpoint", "save_checkpoint"]
