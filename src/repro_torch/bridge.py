"""Parameter exchange between numpy and the port.

The port's parameters are a flat dict of tensors keyed by ``/``-joined key
paths. A torch generator cannot reproduce the reference's ``Model.init``
draws, so every comparison starts both sides from the same bits: the other
side flattens its parameters to ``{path: np.ndarray}`` (numpy only; this
module never sees the other framework), and these two functions carry them
across.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from repro_torch.core.packing import leaf_order


def to_torch(arrays: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """``{path: array}`` -> ``{path: tensor}`` on ``device``, in leaf order."""
    return {p: torch.from_numpy(np.array(arrays[p], copy=True)).to(device)
            for p in leaf_order(arrays)}


def to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """``{path: tensor}`` -> ``{path: np.ndarray}`` on the host."""
    return {p: params[p].detach().cpu().numpy() for p in leaf_order(params)}
