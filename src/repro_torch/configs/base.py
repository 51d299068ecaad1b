"""Arch config registry (port of ``repro.configs.base``): the recsys
architectures (dlrm-rm2, dcn-v2, xdeepfm, din, lma-dlrm-criteo,
lma-dlrm-avazu), the dense LMs (tinyllama-1.1b, stablelm-3b,
qwen1.5-32b), the MoE and MLA LMs (deepseek-v3-671b,
llama4-scout-17b-a16e) and the GAT (gat-cora).  Every arch of the
reference is here, and the LMs serve and train under a (data, model)
mesh as on one card."""
from __future__ import annotations

import dataclasses
from typing import Callable

_REGISTRY: dict[str, "ArchConfig"] = {}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str                      # recsys | lm | gnn
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
    from repro_torch.configs import (dcn_v2,  # noqa: F401
                                    deepseek_v3_671b, din, dlrm_rm2,
                                    gat_cora, llama4_scout_17b_a16e,
                                    lma_dlrm_avazu, lma_dlrm_criteo,
                                    qwen1_5_32b, stablelm_3b,
                                    tinyllama_1_1b, xdeepfm)
