"""Scheme protocol + decorator registry (port of ``repro.embed.registry``).

A scheme is the allocation policy: how value ids map onto trainable
parameters.  ``memory`` schemes share one pool ``params["memory"]`` ([m]
floats) over the global value-id space and contribute ``locations`` plus a
:class:`FusedSpec` for the fused kernel; ``table`` schemes hold per-table
parameters and embed directly through ``embed_rows``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, ClassVar

import torch

if TYPE_CHECKING:
    from repro_torch.embed.config import EmbeddingConfig

_SCHEMES: dict[str, "Scheme"] = {}


class Scheme:
    """Base class for embedding schemes; subclass + ``@register_scheme``."""

    kind: ClassVar[str]
    family: ClassVar[str] = "memory"       # "memory" | "table"
    needs_budget: ClassVar[bool] = True

    def validate(self, cfg: "EmbeddingConfig") -> None:
        if self.needs_budget and cfg.budget is None:
            raise ValueError(f"{self.kind} needs a budget")

    def build_config(self, vocab_sizes: tuple[int, ...], dim: int,
                     budget: int | None, **kw) -> "EmbeddingConfig":
        """Default config at a scalar budget; foreign keyword arguments
        (another scheme's knobs) are dropped."""
        from repro_torch.embed.config import EmbeddingConfig
        fields = {f.name for f in dataclasses.fields(EmbeddingConfig)}
        kw = {k: v for k, v in kw.items() if k in fields}
        return EmbeddingConfig(kind=self.kind, vocab_sizes=tuple(vocab_sizes),
                               dim=dim, budget=budget, **kw)

    def param_count(self, cfg: "EmbeddingConfig") -> int:
        raise NotImplementedError(self.kind)

    def init_params(self, cfg: "EmbeddingConfig", generator: torch.Generator,
                    device: torch.device) -> dict:
        raise NotImplementedError(self.kind)

    def make_buffers(self, cfg: "EmbeddingConfig", store=None) -> dict:
        return {}

    # ------------------------------------------- memory-family lookup hooks
    def locations(self, cfg: "EmbeddingConfig", buffers: dict,
                  gids: torch.Tensor) -> torch.Tensor:
        """[N] global ids -> [N, d] int32 slots into params['memory']."""
        raise NotImplementedError(self.kind)

    def memory_slots(self, cfg: "EmbeddingConfig") -> int:
        return int(cfg.budget)

    def fused_spec(self, cfg: "EmbeddingConfig"):
        """FusedSpec for the fused kernel, or None."""
        return None

    def fused_inputs(self, cfg: "EmbeddingConfig", buffers: dict,
                     gids: torch.Tensor) -> tuple:
        """Extra per-batch kernel inputs ((sets, support) for lma; () else)."""
        return ()

    # -------------------------------------------- table-family embed hook
    def embed_rows(self, cfg: "EmbeddingConfig", params: dict, table: int,
                   flat_ids: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError(self.kind)


def register_scheme(cls: type) -> type:
    """Class decorator: instantiate and register under ``cls.kind``."""
    kind = getattr(cls, "kind", None)
    if not isinstance(kind, str) or not kind:
        raise TypeError(f"{cls.__name__} must define a string `kind`")
    _SCHEMES[kind] = cls()
    return cls


def get_scheme(kind: str) -> Scheme:
    from repro_torch.embed import schemes  # noqa: F401  (registers built-ins)
    if kind not in _SCHEMES:
        raise KeyError(f"unknown embedding scheme {kind!r}; "
                       f"registered: {sorted(_SCHEMES)}")
    return _SCHEMES[kind]

