"""Parameters from the reference package to the port.

The reference keeps a model's parameters as a ``GCNParams`` /
``SAGEParams`` named tuple of arrays; :func:`params_from_numpy` turns one
(or a plain mapping of field name to array) into the port's module, so
that both packages compute the same function in the parity tests.
"""
from __future__ import annotations

from collections.abc import Mapping

import numpy as np
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.gnn.models import MODELS


def params_from_numpy(model: str, params, *, device=None) -> nn.Module:
    """The port's ``model`` ("gcn" | "graphsage") with ``params``' values.

    ``params`` is a named tuple with the reference field names, or a
    mapping of them; each value is anything ``np.asarray`` takes.  The
    module lands on ``device`` (default ``"cuda"``).
    """
    device = resolve_device(device)
    fields = params if isinstance(params, Mapping) else params._asdict()
    arrays = {k: np.asarray(v, np.float32) for k, v in fields.items()}
    return MODELS[model][1](**arrays).to(device)
