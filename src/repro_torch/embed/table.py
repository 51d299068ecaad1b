"""The EmbeddingTable facade: the embedding API models touch.

Port of ``repro.embed.table``.  A frozen dataclass over an
:class:`EmbeddingConfig` with ``init`` / ``make_buffers`` / ``embed`` /
``embed_fields`` / ``embed_bag``; parameters and buffers are plain dicts of
tensors that the caller owns (a model keeps the parameters in an
``nn.ParameterDict``).  Scheme and backend are resolved per call.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import make_generator, resolve_device
from repro_torch.embed import backends as bke
from repro_torch.embed.config import EmbeddingConfig
from repro_torch.embed.registry import get_scheme


def _global_ids(cfg: EmbeddingConfig, table: int,
                ids: torch.Tensor) -> torch.Tensor:
    return ids.to(torch.int32) + int(cfg.table_offsets()[table])


def init_embedding(cfg: EmbeddingConfig,
                   generator: torch.Generator | None = None,
                   device=None) -> dict:
    """Trainable parameters for the configured scheme, drawn on ``device``."""
    dev = resolve_device(device)
    gen = make_generator(cfg.seed, dev) if generator is None else generator
    return get_scheme(cfg.kind).init_params(cfg, gen, dev)


def make_buffers(cfg: EmbeddingConfig, store=None) -> dict:
    """Non-trainable buffers (the D' store for lma; empty otherwise)."""
    return get_scheme(cfg.kind).make_buffers(cfg, store)


def _memory_lookup(cfg, params, buffers, gids):
    scheme = get_scheme(cfg.kind)
    backend = bke.resolve_backend(cfg, params, scheme)
    return backend.lookup(cfg, scheme, params, buffers, gids)


def embed(cfg: EmbeddingConfig, params: dict, buffers: dict, table: int,
          ids: torch.Tensor) -> torch.Tensor:
    """ids [...] (table-local) -> embeddings [..., dim]."""
    scheme = get_scheme(cfg.kind)
    flat = ids.reshape(-1)
    if scheme.family == "memory":
        out = _memory_lookup(cfg, params, buffers,
                             _global_ids(cfg, table, flat))
    else:
        out = scheme.embed_rows(cfg, params, table, flat)
    return out.reshape(*ids.shape, cfg.dim)


def embed_fields(cfg: EmbeddingConfig, params: dict, buffers: dict,
                 ids: torch.Tensor) -> torch.Tensor:
    """ids [B, F] (field f's id in its own vocab) -> [B, F, d].

    Memory-family schemes make one lookup over globalized ids (one kernel
    launch for all fields)."""
    B, F = ids.shape
    if F != cfg.n_tables:
        raise ValueError(f"{F} fields for {cfg.n_tables} tables")
    scheme = get_scheme(cfg.kind)
    if scheme.family == "memory":
        offs = torch.as_tensor(cfg.table_offsets()[:-1], dtype=torch.int32,
                               device=ids.device)
        gids = (ids.to(torch.int32) + offs[None, :]).reshape(-1)
        return _memory_lookup(cfg, params, buffers, gids).reshape(B, F,
                                                                  cfg.dim)
    return torch.stack([embed(cfg, params, buffers, f, ids[:, f])
                        for f in range(F)], dim=1)


def embed_bag(cfg: EmbeddingConfig, params: dict, buffers: dict, table: int,
              ids: torch.Tensor, mask: torch.Tensor,
              mode: str = "sum") -> torch.Tensor:
    """Multi-hot pooling: ids [B, L], mask [B, L] -> [B, dim].

    A CUDA pool pools inside the fused kernel (bag mode); everything else is
    gather + masked reduce."""
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    scheme = get_scheme(cfg.kind)
    backend = bke.resolve_backend(cfg, params, scheme)
    if backend is bke.FUSED:
        w = mask.to(params["memory"].dtype)
        gids = _global_ids(cfg, table, ids.reshape(-1)).reshape(ids.shape)
        s = backend.bag(cfg, scheme, params, buffers, gids, w.contiguous())
    else:
        e = embed(cfg, params, buffers, table, ids)      # [B, L, d]
        w = mask.to(e.dtype)
        s = torch.sum(e * w[..., None], dim=-2)
    if mode == "sum":
        return s
    return s / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)


@dataclasses.dataclass(frozen=True)
class EmbeddingTable:
    """Facade over (config, scheme, backend): what models hold and call."""

    config: EmbeddingConfig

    @property
    def scheme(self):
        return get_scheme(self.config.kind)

    @property
    def param_count(self) -> int:
        return self.config.param_count()

    def init(self, generator: torch.Generator | None = None,
             device=None) -> dict:
        return init_embedding(self.config, generator, device)

    def make_buffers(self, store=None) -> dict:
        return make_buffers(self.config, store)

    def embed(self, params: dict, buffers: dict, table: int,
              ids: torch.Tensor) -> torch.Tensor:
        return embed(self.config, params, buffers, table, ids)

    def embed_fields(self, params: dict, buffers: dict,
                     ids: torch.Tensor) -> torch.Tensor:
        return embed_fields(self.config, params, buffers, ids)

    def embed_bag(self, params: dict, buffers: dict, table: int,
                  ids: torch.Tensor, mask: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
        return embed_bag(self.config, params, buffers, table, ids, mask, mode)
