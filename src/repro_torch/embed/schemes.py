"""The built-in schemes of this slice: full | hashed_elem | hashed_row | lma.

Port of ``repro.embed.schemes`` (``qr`` and ``md`` come later).  Parameter
and buffer names follow the reference (``table_{t}``, ``memory``,
``store_sets``, ``store_lengths``) so ``repro_torch.convert`` carries them
across by name.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import allocation as alc
from repro_torch.core.allocation import LMAParams
from repro_torch.core.memory import init_memory
from repro_torch.core.signatures import DenseSignatureStore
from repro_torch.embed.config import EmbeddingConfig
from repro_torch.embed.registry import Scheme, register_scheme
from repro_torch.kernels.fused_embed import ops as fe


@register_scheme
class FullScheme(Scheme):
    """One uncompressed [V, d] table per field (the paper's A_full)."""

    kind = "full"
    family = "table"
    needs_budget = False

    def build_config(self, vocab_sizes, dim, budget, **kw):
        kw.pop("budget", None)
        return super().build_config(vocab_sizes, dim, None, **kw)

    def param_count(self, cfg):
        return cfg.total_vocab * cfg.dim

    def init_params(self, cfg, generator, device):
        scale = cfg.scale_or_default()
        return {f"table_{t}": (torch.randn((v, cfg.dim), generator=generator,
                                           device=device) * scale
                               ).to(cfg.tdtype)
                for t, v in enumerate(cfg.vocab_sizes)}

    def embed_rows(self, cfg, params, table, flat_ids):
        return params[f"table_{table}"][flat_ids.long()]


class _HashedBase(Scheme):
    """Common memory + pure-hash locations (HashedNet-style tricks)."""

    def init_params(self, cfg, generator, device):
        self.validate(cfg)
        return {"memory": init_memory(cfg.budget, "normal",
                                      cfg.scale_or_default(), cfg.tdtype,
                                      generator, device)}

    def param_count(self, cfg):
        return int(cfg.budget)

    def fused_spec(self, cfg):
        return fe.hashed_spec(self.kind, cfg.dim, cfg.budget, cfg.seed)


@register_scheme
class HashedElemScheme(_HashedBase):
    kind = "hashed_elem"

    def locations(self, cfg, buffers, gids):
        return alc.alloc_hashed_elem(gids, cfg.dim, cfg.budget, cfg.seed)


@register_scheme
class HashedRowScheme(_HashedBase):
    kind = "hashed_row"

    def locations(self, cfg, buffers, gids):
        return alc.alloc_hashed_row(gids, cfg.dim, cfg.budget, cfg.seed)


@register_scheme
class LMAScheme(Scheme):
    """The paper's semantically-constrained allocation A_L (section 4)."""

    kind = "lma"

    def validate(self, cfg):
        super().validate(cfg)
        if cfg.lma is None:
            raise ValueError("lma needs LMAParams")

    def build_config(self, vocab_sizes, dim, budget, n_h: int = 4,
                     max_set: int = 32, seed: int = 0,
                     striped: bool | None = None, **kw):
        kw.setdefault("memory_init", "bernoulli")
        kw.setdefault("init_scale", 1.0 / np.sqrt(dim))
        # the striped layout whenever the budget tiles into d stripes
        if striped is None:
            striped = budget is not None and budget % dim == 0
        return EmbeddingConfig(
            kind="lma", vocab_sizes=tuple(vocab_sizes), dim=dim, budget=budget,
            lma=LMAParams(d=dim, m=budget, n_h=n_h, max_set=max_set,
                          seed=seed, striped=striped),
            seed=seed, **kw)

    def param_count(self, cfg):
        return int(cfg.budget)

    def init_params(self, cfg, generator, device):
        self.validate(cfg)
        scale = cfg.init_scale
        if scale is None:
            scale = 1.0 if cfg.memory_init == "bernoulli" \
                else 1.0 / np.sqrt(cfg.dim)
        return {"memory": init_memory(cfg.budget, cfg.memory_init, scale,
                                      cfg.tdtype, generator, device)}

    def make_buffers(self, cfg, store=None):
        if not isinstance(store, DenseSignatureStore):
            raise TypeError("lma needs a DenseSignatureStore (D')")
        return {"store_sets": store.sets, "store_lengths": store.lengths}

    def locations(self, cfg, buffers, gids):
        store = DenseSignatureStore(buffers["store_sets"],
                                    buffers["store_lengths"])
        return alc.alloc_lma(cfg.lma, store, gids)

    def memory_slots(self, cfg):
        return int(cfg.lma.m)

    def fused_spec(self, cfg):
        return fe.lma_spec(cfg.lma)

    def fused_inputs(self, cfg, buffers, gids):
        """D' rows (truncated to max_set) + support for a flat [N] batch."""
        g = gids.long()
        rows = buffers["store_sets"][g, : cfg.lma.max_set].contiguous()
        return rows, buffers["store_lengths"][g]
