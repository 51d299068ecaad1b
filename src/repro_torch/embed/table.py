"""The EmbeddingTable facade: the embedding API models touch.

Port of ``repro.embed.table``.  A frozen dataclass over an
:class:`EmbeddingConfig` with ``init`` / ``make_buffers`` / ``embed`` /
``embed_fields`` / ``embed_bag`` / ``materialize_rows``; parameters and buffers are plain dicts of
tensors that the caller owns (a model keeps the parameters in an
``nn.ParameterDict``).  Scheme and backend are resolved per call.

Given a mesh (``repro_torch.dist``), ``init`` and ``make_buffers`` keep
only this rank's slab of the pool and its rows of the D' store (a CSR
store re-based per rank, ``shard_csr_buffers``); lookups under that
installed mesh take the sharded backend.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import make_generator, resolve_device
from repro_torch.dist.sharding import row_slab, shard_buffers
from repro_torch.embed import backends as bke
from repro_torch.embed.config import EmbeddingConfig
from repro_torch.embed.registry import get_scheme
from repro_torch.optim import sparse


def _global_ids(cfg: EmbeddingConfig, table: int,
                ids: torch.Tensor) -> torch.Tensor:
    return ids.to(torch.int32) + int(cfg.table_offsets()[table])


def init_embedding(cfg: EmbeddingConfig,
                   generator: torch.Generator | None = None,
                   device=None, mesh=None) -> dict:
    """Trainable parameters for the configured scheme, drawn on ``device``;
    with a mesh, a memory scheme's pool is this rank's slab.  The whole
    pool is drawn first, so the slabs are those of the single-device pool
    and the generator moves on as it would there."""
    dev = resolve_device(device)
    gen = make_generator(cfg.seed, dev) if generator is None else generator
    scheme = get_scheme(cfg.kind)
    params = scheme.init_params(cfg, gen, dev)
    if scheme.family == "memory":
        params["memory"] = row_slab(params["memory"], mesh)
    return params


def make_buffers(cfg: EmbeddingConfig, store=None, mesh=None,
                 device=None) -> dict:
    """Non-trainable buffers (the D' store for lma, the hot ids for freq;
    empty otherwise); with a mesh, this rank's rows of the D' store (a
    dense store's rows must divide by P: pad it to
    ``repro_torch.dist.sharding.store_rows``; a CSR store is re-based per
    rank, ``shard_csr_buffers``), every other buffer whole.  Buffers a
    scheme builds from host data (freq's counts, a host CSR store) go to
    ``device``, the card unless it says otherwise; a dense D' store stays
    where it is."""
    return shard_buffers(get_scheme(cfg.kind).make_buffers(cfg, store,
                                                           device), mesh)


def _memory_lookup(cfg, params, buffers, gids):
    """[N] global ids -> [N, d] through the resolved backend.

    Under an active sparse-gradient capture (``repro_torch.optim.sparse``)
    the lookup is recorded: its backward yields what the lookup touched and
    the incoming gradient instead of a dense [m] pool gradient.  A
    row-aligned scheme records its [N] pool rows when the budget tiles into
    d-wide rows; a ragged budget (m % d != 0), and every other scheme,
    records the [N, d] element locations (under a mesh, those the sharded
    lookup assembled).  A tiered pool records element locations remapped
    into its compact pool, whose slots they index: the remap is
    element-wise, so rows and stripes do not survive it (as in the
    reference)."""
    scheme = get_scheme(cfg.kind)
    backend = bke.resolve_backend(cfg, params, scheme, buffers)
    cap = sparse.active()
    if cap is None:
        return backend.lookup(cfg, scheme, params, buffers, gids)
    tiered = backend is bke.TIERED
    slots = (int(params["memory"].shape[0]) if tiered
             else scheme.memory_slots(cfg))
    if isinstance(backend, bke.ShardedBackend):
        held = []

        def lookup():
            held.append(backend.assemble(cfg, scheme, params, buffers, gids))
            return held[0].out

        def locations():
            return held[0].locations()
    else:
        def lookup():
            return backend.lookup(cfg, scheme, params, buffers, gids)

        def locations():
            return bke.sparse_locations(cfg, scheme, params, buffers, gids)

    if not tiered and scheme.row_aligned and slots % cfg.dim == 0:
        return cap.lookup(
            params["memory"], lookup,
            lambda: scheme.sparse_row_ids(cfg, buffers, gids),
            row_width=cfg.dim, slots=slots)
    return cap.lookup(params["memory"], lookup, locations,
                      0 if tiered else scheme.sparse_buckets(cfg),
                      slots=slots)


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
    gather + masked reduce.  Under a sparse-gradient capture the bag
    decomposes into embed + masked reduce, so the per-element lookup is the
    one recorded and its gradient arrives already weighted (g[b] * w[b, l])."""
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    scheme = get_scheme(cfg.kind)
    backend = bke.resolve_backend(cfg, params, scheme, buffers)
    if backend is bke.FUSED and sparse.active() is None:
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


def materialize_rows(cfg: EmbeddingConfig, params: dict, buffers: dict,
                     table: int, n_rows: int | None = None) -> torch.Tensor:
    """The [V, d] virtual rows of table ``table`` (its first ``n_rows``):
    for LM output heads and small vocabularies only."""
    v = cfg.vocab_sizes[table] if n_rows is None else n_rows
    device = next(iter(params.values())).device
    ids = torch.arange(v, dtype=torch.int32, device=device)
    return embed(cfg, params, buffers, table, ids)


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
             device=None, mesh=None) -> dict:
        return init_embedding(self.config, generator, device, mesh)

    def make_buffers(self, store=None, mesh=None, device=None) -> dict:
        return make_buffers(self.config, store, mesh, device)

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

    def materialize_rows(self, params: dict, buffers: dict, table: int,
                         n_rows: int | None = None) -> torch.Tensor:
        return materialize_rows(self.config, params, buffers, table, n_rows)
