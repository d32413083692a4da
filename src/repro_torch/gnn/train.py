"""Full-batch GNN training (paper §4.1 trains in DGL; the reference package
trains in JAX, and the port in torch autograd, with the exact
cuSPARSE-role aggregation), then *inference* with the sampled kernels —
the paper's protocol of sampling only at inference.

No kernel runs in training: ``exact_agg`` is ``ref.csr_spmm`` (a gather
and an ``index_add_``), as the reference's is a segment sum outside any
Pallas kernel.  On the card ``index_add_`` and the gather's backward sum
in atomic order, so training there is not bit-reproducible.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.gnn.datasets import GraphDataset
from repro_torch.gnn.models import MODELS, exact_agg
from repro_torch.optim import adamw_init, adamw_update


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood over the ``mask``ed nodes."""
    mask = mask.to(torch.float32)
    logp = torch.log_softmax(logits, dim=1)
    nll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    return torch.sum(nll * mask) / torch.clamp(mask.sum(), min=1)


def accuracy(logits: torch.Tensor, labels: torch.Tensor,
             mask: torch.Tensor) -> float:
    """Share of ``mask``ed nodes whose argmax logit is their label."""
    mask = mask.to(torch.float32)
    correct = (logits.argmax(dim=1) == labels).to(torch.float32) * mask
    return float(correct.sum() / torch.clamp(mask.sum(), min=1))


def train_model(ds: GraphDataset, model: str = "gcn", hidden: int = 64,
                epochs: int = 150, lr: float = 5e-3, seed: int = 0,
                weight_decay: float = 5e-4, *, device=None):
    """Returns ``(module, ideal_test_accuracy)`` — the paper's "ideal
    accuracy" is the trained model evaluated with the exact kernel.

    The initial parameters are the reference's draws from
    ``np.random.default_rng(seed)``; each epoch is one full-batch step of
    the reference's AdamW on the train mask's cross entropy.  Runs on
    ``device`` (default ``"cuda"``; a missing card raises), where ``ds``
    is copied.  The module comes back as the model constructors return
    it, its parameters with ``requires_grad=False``.
    """
    device = resolve_device(device)
    init_fn, _, adj_name = MODELS[model]
    ds = ds.to(device)
    adj, x = getattr(ds, adj_name), ds.features
    module = init_fn(np.random.default_rng(seed), x.shape[1], hidden,
                     ds.spec.num_classes, device=device)
    params = dict(module.named_parameters())
    opt = adamw_init(params)
    for p in params.values():
        p.requires_grad_(True)
    try:
        for _ in range(epochs):
            loss = cross_entropy(module(adj, x, exact_agg), ds.labels,
                                 ds.train_mask)
            grads = dict(zip(params, torch.autograd.grad(
                loss, list(params.values()))))
            with torch.no_grad():
                new, opt = adamw_update(grads, opt, params, lr=lr,
                                        weight_decay=weight_decay)
                for k, p in params.items():
                    p.copy_(new[k])
    finally:
        for p in params.values():
            p.requires_grad_(False)
    with torch.inference_mode():
        logits = module(adj, x, exact_agg)
        test_acc = accuracy(logits, ds.labels, ds.test_mask)
    return module, test_acc
