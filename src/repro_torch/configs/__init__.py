"""Architecture registry: ``get_config(name)`` / ``--arch <id>``."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.configs.tinygpt_15m import CONFIG as _tinygpt

ARCHS: Dict[str, ModelConfig] = {_tinygpt.name: _tinygpt}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return reduced(get_config(name[: -len("-smoke")]))
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "get_config", "reduced"]
