"""Arch config registry (port of ``repro.configs.base``): the recsys
architectures this slice serves."""
from __future__ import annotations

import dataclasses
from typing import Callable

_REGISTRY: dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                      # recsys
    make_model: Callable             # (shape_id: str|None) -> full-scale config
    make_smoke: Callable             # () -> reduced config
    shapes: tuple[str, ...]
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    source: str = ""
    notes: str = ""


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ArchConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    from repro_torch.configs import dlrm_rm2, lma_dlrm_criteo  # noqa: F401
