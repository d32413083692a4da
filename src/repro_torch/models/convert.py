"""LM parameters from the reference package to the port.

The reference keeps an LM's parameters as a nested dict whose uniform
``layers`` are stacked on a leading ``L`` axis; :func:`params_from_numpy`
turns such a tree, its leaves numpy arrays, into the port's :class:`LM`,
so that both packages compute with the same weights in the parity tests.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import LM, require_uniform


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _convert(tree, device):
    if isinstance(tree, Mapping):
        return {k: _convert(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def _layer(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_numpy(cfg: ArchConfig, tree: Mapping, device=None) -> LM:
    """The port's :class:`LM` holding ``tree``'s values on ``device``
    (default ``"cuda"``), in their own dtypes."""
    require_uniform(cfg)
    device = resolve_device(device)
    out = {k: _convert(v, device) for k, v in tree.items() if k != "layers"}
    out["layers"] = [_convert(_layer(tree["layers"], i), device)
                     for i in range(cfg.num_layers)]
    return LM(out)
