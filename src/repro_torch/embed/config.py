"""EmbeddingConfig: the one declarative description of an embedding subsystem.

Port of ``repro.embed.config``.  ``kind`` selects a registered
:class:`~repro_torch.embed.registry.Scheme`; the backend (plain split
version or fused kernel) is resolved at lookup time by
``repro_torch.embed.backends``.  Memory-family schemes address one shared
pool over the global value-id space ``table_offsets[t] + v``.

Scheme-specific hyper-parameters the core config does not know about (the
``freq`` scheme's hot-row count) travel in ``options``, a frozen ``(name,
value)`` tuple, so the config stays hashable.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.allocation import LMAParams
from repro_torch.core.signatures import table_offsets


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
    md_dims: Optional[tuple[int, ...]] = None  # mixed-dimension per-table dims
    dtype: str = "float32"
    options: tuple[tuple[str, Any], ...] = ()  # scheme-specific hypers

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

    def opt(self, name: str, default: Any = None) -> Any:
        """Scheme-specific option lookup (see ``options``)."""
        for k, v in self.options:
            if k == name:
                return v
        return default

    def scale_or_default(self, d: int | None = None) -> float:
        """``init_scale`` if set, else the 1/sqrt(d) activation default."""
        d = self.dim if d is None else d
        return self.init_scale if self.init_scale is not None \
            else 1.0 / np.sqrt(d)

    @property
    def expansion_rate(self) -> float:
        """alpha = simulated size / actual parameters (paper section 7.1),
        from ``param_count()``, so qr and md report their real
        compression."""
        return self.total_vocab * self.dim / max(self.param_count(), 1)

    def param_count(self) -> int:
        from repro_torch.embed.registry import get_scheme
        return get_scheme(self.kind).param_count(self)
