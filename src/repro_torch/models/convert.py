"""LM parameters from the reference package to the port.

The reference keeps an LM's parameters as a nested dict: the uniform
``layers`` stacked on a leading ``L`` axis, Zamba2's ``groups`` stacked
``[G, per, ...]`` (their ``norms`` ``[G, per + 1, d]``) and its ``tail``
``[tail, ...]``, xLSTM's ``blocks`` a list (a ``shared_attn`` entry an
empty dict).  :func:`params_from_numpy` turns such a tree, its leaves
numpy arrays, into the port's :class:`LM`, one module a layer or block,
so that both packages compute with the same weights in the parity tests.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import LM, _group_layout


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _convert(tree, device):
    if isinstance(tree, Mapping):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device) for v in tree]
    return _tensor(tree, device)


def _index(tree, *index):
    """Every leaf of ``tree`` at ``index`` along its leading axes."""
    if isinstance(tree, Mapping):
        return {k: _index(v, *index) for k, v in tree.items()}
    return np.asarray(tree)[index]


def params_from_numpy(cfg: ArchConfig, tree: Mapping, device=None) -> LM:
    """The port's :class:`LM` holding ``tree``'s values on ``device``
    (default ``"cuda"``), in their own dtypes."""
    device = resolve_device(device)
    out = {k: _convert(v, device) for k, v in tree.items()
           if k not in ("layers", "groups", "tail")}
    if "layers" in tree:
        out["layers"] = [_convert(_index(tree["layers"], i), device)
                         for i in range(cfg.num_layers)]
    if "groups" in tree:
        G, per, tail = _group_layout(cfg)
        groups = tree["groups"]
        out["groups"] = [
            {"mamba": [_convert(_index(groups["mamba"], g, j), device)
                       for j in range(per)],
             "norms": _tensor(np.asarray(groups["norms"])[g], device)}
            for g in range(G)]
        if tail:
            out["tail"] = {
                "mamba": [_convert(_index(tree["tail"]["mamba"], j), device)
                          for j in range(tail)],
                "norms": _tensor(tree["tail"]["norms"], device)}
    return LM(out)
