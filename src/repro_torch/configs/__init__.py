"""Architecture registry: ``get_config(name)`` / ``--arch <id>``."""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

from repro_torch.configs.base import (
    HeLoCoConfig,
    InnerOptConfig,
    ModelConfig,
    MoEConfig,
    OuterOptConfig,
    RunConfig,
    ShapeConfig,
    SHAPES,
    SSMConfig,
    XLSTMConfig,
    reduced,
    shape_applicable,
)

from repro_torch.configs.zamba2_2p7b import CONFIG as _zamba2
from repro_torch.configs.qwen2_7b import CONFIG as _qwen2
from repro_torch.configs.granite_3_8b import CONFIG as _granite3
from repro_torch.configs.command_r_35b import CONFIG as _commandr
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as _granitemoe
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4
from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.xlstm_125m import CONFIG as _xlstm
from repro_torch.configs.paligemma_3b import CONFIG as _paligemma
from repro_torch.configs.tinygpt_15m import CONFIG as _tinygpt

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _zamba2, _qwen2, _granite3, _commandr, _starcoder2,
        _granitemoe, _llama4, _hubert, _xlstm, _paligemma, _tinygpt,
    )
}

ASSIGNED = tuple(n for n in ARCHS if n != "tinygpt-15m")


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(get_config(name[: -len("-smoke")]))
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cells() -> Iterator[Tuple[ModelConfig, ShapeConfig, bool, str]]:
    """All 40 assigned (arch x shape) cells with applicability."""
    for arch in ASSIGNED:
        m = ARCHS[arch]
        for shape in SHAPES.values():
            ok, why = shape_applicable(m, shape)
            yield m, shape, ok, why


__all__ = [
    "ARCHS", "ASSIGNED", "SHAPES", "get_config", "cells", "reduced",
    "ModelConfig", "ShapeConfig", "RunConfig", "MoEConfig", "SSMConfig",
    "XLSTMConfig", "HeLoCoConfig", "OuterOptConfig", "InnerOptConfig",
    "shape_applicable",
]
