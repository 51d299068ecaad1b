"""``freq``: frequency-tiered hashed-row scheme (port of
``repro.embed.freq``).

The access frequency of recommendation ids is extremely skewed (RecShard,
arXiv 2201.10095: the hottest ~1% of rows serve most lookups).  This scheme
splits the shared pool into two tiers over the global value-id space:

  * **hot tier**: the top-k hot ids each own a dedicated, collision-free
    d-slot row at the front of the pool (slots ``[rank*d, rank*d + d)``);
  * **tail tier**: every other id row-hashes into the remaining
    ``(budget - k*d) / d`` rows (whole-row collisions, like ``hashed_row``).

Hot-id membership is a sorted int32 buffer (``freq_hot_ids``) built by
``make_buffers`` from observed id counts; with no counts the first ``k``
global ids are taken.  A lookup is a binary search against that buffer and
one hash: location math only, so it has no fused spec and every lookup
takes the split path (plain PyTorch: ``torch.searchsorted``, the hash, a
gather); its sparse gradient is row mode.

It registers itself and is never imported by ``repro_torch.embed.table`` or
the backend resolver: deleting this file removes the scheme and nothing
else.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hashing import hash_u32, seed_stream
from repro_torch.core.memory import init_memory
from repro_torch.device import resolve_device
from repro_torch.embed.config import EmbeddingConfig
from repro_torch.embed.registry import Scheme, register_scheme

DEFAULT_HOT_K = 1024
SEED_XOR = 0x0F5EC     # the tail hash's seed is cfg.seed ^ SEED_XOR


@register_scheme
class FreqScheme(Scheme):
    """Frequency-tiered rows: dedicated head, hashed-row tail, one pool."""

    kind = "freq"
    buffer_source = "id_counts"
    row_aligned = True

    def validate(self, cfg):
        super().validate(cfg)
        if cfg.budget < 2 * cfg.dim:
            raise ValueError(f"freq needs budget >= 2*dim (one hot row + one "
                             f"tail row), got {cfg.budget} < {2 * cfg.dim}")

    def build_config(self, vocab_sizes, dim, budget, hot_k: int | None = None,
                     **kw):
        if hot_k is not None:
            # an explicit argument wins: drop any earlier entry (opt()
            # returns the first match)
            rest = tuple(kv for kv in kw.get("options", ())
                         if kv[0] != "hot_k")
            kw["options"] = (("hot_k", hot_k),) + rest
        return super().build_config(vocab_sizes, dim, budget, **kw)

    def hot_k(self, cfg: EmbeddingConfig) -> int:
        """The hot tier's size: the requested top-k, clamped so that at
        least one tail row survives in the budget."""
        k = int(cfg.opt("hot_k", DEFAULT_HOT_K))
        max_k = cfg.budget // cfg.dim - 1
        return max(0, min(k, max_k, cfg.total_vocab))

    def tail_rows(self, cfg: EmbeddingConfig) -> int:
        return (cfg.budget - self.hot_k(cfg) * cfg.dim) // cfg.dim

    def param_count(self, cfg):
        super().validate(cfg)
        return int(cfg.budget)

    def init_params(self, cfg, generator, device):
        self.validate(cfg)
        return {"memory": init_memory(cfg.budget, "normal",
                                      cfg.scale_or_default(), cfg.tdtype,
                                      generator, device)}

    def buffer_specs(self, cfg, n_store_rows):
        return {"freq_hot_ids": ((self.hot_k(cfg),), "int32")}

    def make_buffers(self, cfg, store=None, device=None):
        """``store``: optional per-global-id counts ([>= total_vocab]
        integers, numpy or a tensor).  The top-k ids by count (ties to the
        lower id) become the hot tier, sorted for the binary search; no
        counts takes the first k global ids.  On ``device`` (the card
        unless it says otherwise)."""
        k = self.hot_k(cfg)
        if store is None:
            hot = np.arange(k, dtype=np.int32)
        else:
            counts = np.asarray(store.cpu() if isinstance(store, torch.Tensor)
                                else store)
            if counts.ndim != 1 or counts.shape[0] < cfg.total_vocab:
                raise ValueError(f"freq expects per-global-id counts, got "
                                 f"shape {counts.shape}")
            counts = counts[: cfg.total_vocab]
            order = np.lexsort((np.arange(counts.shape[0]), -counts))
            hot = np.sort(order[:k]).astype(np.int32)
        return {"freq_hot_ids": torch.from_numpy(hot).to(
            resolve_device(device))}

    def _hot_ids(self, cfg, buffers, device) -> torch.Tensor:
        hot = buffers.get("freq_hot_ids")
        if hot is None:     # the buffer-less default: the first k global ids
            hot = torch.arange(self.hot_k(cfg), dtype=torch.int32,
                               device=device)
        return hot

    def sparse_row_ids(self, cfg, buffers, gids):
        """Pool row per gid (its hot rank, or k + its tail hash): the row
        index of ``locations``, shared bit for bit."""
        hot = self._hot_ids(cfg, buffers, gids.device)
        k = int(hot.shape[0])
        tail_rows = (cfg.budget - k * cfg.dim) // cfg.dim
        gi = gids.to(torch.int32)
        seed = seed_stream(cfg.seed ^ SEED_XOR, 1, gids.device)[0]
        row = (hash_u32(gids, seed) % max(tail_rows, 1)).to(torch.int32)
        if k == 0:
            return row
        # the reference's jnp.searchsorted: side left, then clipped
        rank = torch.clamp(torch.searchsorted(hot, gi), 0, k - 1)
        is_hot = hot[rank] == gi
        return torch.where(is_hot, rank.to(torch.int32), k + row)

    def locations(self, cfg, buffers, gids):
        lane = torch.arange(cfg.dim, dtype=torch.int32, device=gids.device)
        return self.sparse_row_ids(cfg, buffers, gids)[:, None] * cfg.dim \
            + lane[None, :]

    def extra_describe(self, cfg):
        return {"hot_k": self.hot_k(cfg), "tail_rows": self.tail_rows(cfg)}
