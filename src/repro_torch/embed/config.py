"""EmbeddingConfig: the one declarative description of an embedding subsystem.

Port of ``repro.embed.config``.  ``kind`` selects a registered
:class:`~repro_torch.embed.registry.Scheme`; the backend (plain split
version or fused kernel) is resolved at lookup time by
``repro_torch.embed.backends``.  Memory-family schemes address one shared
pool over the global value-id space ``table_offsets[t] + v``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.allocation import LMAParams


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    kind: str                      # any registered scheme kind
    vocab_sizes: tuple[int, ...]   # one entry per table
    dim: int
    budget: Optional[int] = None   # total scalar budget m for compressed kinds
    lma: Optional[LMAParams] = None
    seed: int = 0
    init_scale: Optional[float] = None   # None -> scheme default
    memory_init: str = "normal"          # lma: "bernoulli" (Thm 2) or "normal"
    md_dims: Optional[tuple[int, ...]] = None  # md scheme (a later slice)
    dtype: str = "float32"
    options: tuple[tuple[str, Any], ...] = ()  # freq scheme (a later slice)

    @property
    def n_tables(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def table_offsets(self) -> np.ndarray:
        return table_offsets(self.vocab_sizes)

    def scale_or_default(self, d: int | None = None) -> float:
        """``init_scale`` if set, else the 1/sqrt(d) activation default."""
        d = self.dim if d is None else d
        return self.init_scale if self.init_scale is not None \
            else 1.0 / np.sqrt(d)

    def param_count(self) -> int:
        from repro_torch.embed.registry import get_scheme
        return get_scheme(self.kind).param_count(self)


def table_offsets(vocab_sizes) -> np.ndarray:
    """Global-id bases for common-memory multi-table lookups (paper sec 5)."""
    return np.concatenate([[0], np.cumsum(np.asarray(vocab_sizes, np.int64))])
