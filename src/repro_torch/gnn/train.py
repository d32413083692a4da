"""Training-side helpers.  This slice of the port carries ``accuracy``
only; ``train_model`` comes with the training slice (the parity tests
train in the reference package and convert its parameters with
``repro_torch.gnn.convert.params_from_numpy``)."""
from __future__ import annotations

import torch


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> float:
    """Share of ``mask``ed nodes whose argmax logit is their label."""
    mask = mask.to(torch.float32)
    correct = (logits.argmax(dim=1) == labels).to(torch.float32) * mask
    return float(correct.sum() / torch.clamp(mask.sum(), min=1))
