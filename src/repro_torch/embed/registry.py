"""Scheme protocol + decorator registry (port of ``repro.embed.registry``).

A scheme is the allocation policy: how value ids map onto trainable
parameters.  ``memory`` schemes share one pool ``params["memory"]`` ([m]
floats) over the global value-id space and contribute ``locations`` and,
optionally, a :class:`FusedSpec` for the fused kernel (without one, every
lookup takes the split path); ``table`` schemes hold per-table
parameters and embed directly through ``embed_rows``.

Registering a scheme is one decorated class in its own module, with no
edit to ``repro_torch.embed.table`` or the backend resolver:
``repro_torch/embed/freq.py`` registers itself and nothing imports it but
``_ensure_builtin``.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, ClassVar

import torch

if TYPE_CHECKING:
    from repro_torch.embed.config import EmbeddingConfig

_SCHEMES: dict[str, "Scheme"] = {}
_BUILTIN_LOADED = False


class Scheme:
    """Base class for embedding schemes; subclass + ``@register_scheme``."""

    kind: ClassVar[str]
    family: ClassVar[str] = "memory"       # "memory" | "table"
    needs_budget: ClassVar[bool] = True
    # True when ``locations`` are d-aligned pool rows (``sparse_row_ids``
    # gives them): a sparse gradient then carries one index per row
    row_aligned: ClassVar[bool] = False
    # What make_buffers consumes: None (no buffers), "signatures" (a D'
    # store, lma) or "id_counts" (per-global-id observed counts, freq).
    # Launchers key data preparation on this.
    buffer_source: ClassVar[str | None] = None

    @property
    def needs_signature_store(self) -> bool:
        return self.buffer_source == "signatures"

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

    def describe(self, cfg: "EmbeddingConfig") -> dict:
        """JSON-serializable introspection row."""
        d = {
            "kind": self.kind,
            "family": self.family,
            "n_tables": cfg.n_tables,
            "total_vocab": cfg.total_vocab,
            "dim": cfg.dim,
            "budget": cfg.budget,
            "param_count": self.param_count(cfg),
            "expansion_rate": round(cfg.expansion_rate, 4),
        }
        d.update(self.extra_describe(cfg))
        return d

    def extra_describe(self, cfg: "EmbeddingConfig") -> dict:
        return {}

    def init_params(self, cfg: "EmbeddingConfig", generator: torch.Generator,
                    device: torch.device) -> dict:
        raise NotImplementedError(self.kind)

    def make_buffers(self, cfg: "EmbeddingConfig", store=None,
                     device=None) -> dict:
        """Non-trainable buffers from ``store`` (what ``buffer_source``
        names); a scheme whose store is host data puts them on ``device``
        (the card unless it says otherwise)."""
        return {}

    def buffer_specs(self, cfg: "EmbeddingConfig",
                     n_store_rows: int) -> dict:
        """Abstract buffer layout: name -> (shape tuple, dtype str);
        ``n_store_rows`` is the padded row count of a row-sharded store.
        Schemes without buffers return {}."""
        return {}

    # ------------------------------------------- memory-family lookup hooks
    def locations(self, cfg: "EmbeddingConfig", buffers: dict,
                  gids: torch.Tensor) -> torch.Tensor:
        """[N] global ids -> [N, d] int32 slots into params['memory']."""
        raise NotImplementedError(self.kind)

    def memory_slots(self, cfg: "EmbeddingConfig") -> int:
        return int(cfg.budget)

    def fused_spec(self, cfg: "EmbeddingConfig"):
        """FusedSpec for the fused kernel, or None (split path only)."""
        return None

    def fused_inputs(self, cfg: "EmbeddingConfig", buffers: dict,
                     gids: torch.Tensor) -> tuple:
        """Extra per-batch kernel inputs ((sets, support) for lma; () else)."""
        return ()

    def sharded_lookup(self, cfg: "EmbeddingConfig", params: dict,
                       buffers: dict, gids: torch.Tensor, mesh):
        """This scheme's sharded lookup on a rank's slab (a
        ``repro_torch.dist.sharded_memory.SlabLookup``).  The default is the
        generic location lookup (``sharded_location_lookup``) over
        ``locations``, which must then need no store sharded over 'model'
        (freq's hot ids are replicated), as the reference's fallback."""
        from repro_torch.dist.sharded_memory import sharded_location_lookup
        return sharded_location_lookup(
            params["memory"], gids, lambda g: self.locations(cfg, buffers, g),
            cfg.dim, self.memory_slots(cfg), mesh)

    def sparse_buckets(self, cfg: "EmbeddingConfig") -> int:
        """d when column j of ``locations`` always lies in stripe
        ``[j*(m//d), (j+1)*(m//d))`` (striped lma), else 0.  Non-zero lets
        the sparse-gradient capture build the pool's SparseGrad with d
        per-stripe sorts (``optim.sparse.from_bucketed_locations``) and the
        update fold the duplicates, instead of one global sort and dedup."""
        return 0

    def sparse_row_ids(self, cfg: "EmbeddingConfig", buffers: dict,
                       gids: torch.Tensor) -> torch.Tensor | None:
        """[N] int32 pool rows when this scheme's locations are d-aligned
        rows (``locations == rows[:, None] * dim + arange(dim)``), else None.
        With a budget that tiles into rows, the sparse-gradient capture then
        records one index per row (the reference's ``record_rows``) and the
        optimizers update ``[rows, d]`` states, d values an index."""
        return None

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


def _ensure_builtin() -> None:
    global _BUILTIN_LOADED
    if _BUILTIN_LOADED:
        return
    _BUILTIN_LOADED = True
    # import side-effect registration
    from repro_torch.embed import freq, schemes  # noqa: F401


def get_scheme(kind: str) -> Scheme:
    _ensure_builtin()
    if kind not in _SCHEMES:
        raise KeyError(f"unknown embedding scheme {kind!r}; "
                       f"registered: {sorted(_SCHEMES)}")
    return _SCHEMES[kind]


def list_schemes() -> list[str]:
    _ensure_builtin()
    return sorted(_SCHEMES)

