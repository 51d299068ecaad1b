"""The six built-in schemes: full | hashed_elem | hashed_row | qr | lma | md.

Port of ``repro.embed.schemes`` (``freq`` registers itself from
``repro_torch/embed/freq.py``).  Parameter and buffer names follow the
reference (``table_{t}`` for full and md, ``memory``, ``q_{t}`` / ``r_{t}``
for qr, ``proj_{t}`` for md; LMA's D' as ``store_sets`` and
``store_lengths``, or in CSR form ``store_flat``, ``store_offsets`` and
``store_lengths``; under a mesh the CSR form's ``store_flat_sh`` and
``store_offsets_sh``, a rank's re-based part) so ``repro_torch.convert``
carries them across by name.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import allocation as alc
from repro_torch.core.allocation import LMAParams
from repro_torch.core.hashing import hash_u32, seed_stream
from repro_torch.core.memory import init_memory
from repro_torch.core.signatures import (DenseSignatureStore,
                                         SignatureStore, csr_on)
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

    def sharded_lookup(self, cfg, params, buffers, gids, mesh):
        from repro_torch.dist.sharded_memory import sharded_hashed_lookup
        return sharded_hashed_lookup(params["memory"], gids, cfg.dim,
                                     cfg.budget, cfg.seed, mesh,
                                     kind=self.kind)


@register_scheme
class HashedElemScheme(_HashedBase):
    kind = "hashed_elem"

    def locations(self, cfg, buffers, gids):
        return alc.alloc_hashed_elem(gids, cfg.dim, cfg.budget, cfg.seed)


@register_scheme
class HashedRowScheme(_HashedBase):
    kind = "hashed_row"
    row_aligned = True

    def locations(self, cfg, buffers, gids):
        return alc.alloc_hashed_row(gids, cfg.dim, cfg.budget, cfg.seed)

    def sparse_row_ids(self, cfg, buffers, gids):
        # the row index of alloc_hashed_row, bit for bit
        n_rows = max(cfg.budget // cfg.dim, 1)
        seed = seed_stream(cfg.seed, 1, gids.device)[0]
        return (hash_u32(gids, seed) % n_rows).to(torch.int32)


@register_scheme
class LMAScheme(Scheme):
    """The paper's semantically-constrained allocation A_L (section 4)."""

    kind = "lma"
    buffer_source = "signatures"

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

    def buffer_specs(self, cfg, n_store_rows):
        return {"store_sets": ((n_store_rows, cfg.lma.max_set), "uint32"),
                "store_lengths": ((n_store_rows,), "int32")}

    def make_buffers(self, cfg, store=None, device=None):
        """A dense store's tensors as they are; a CSR store's (numpy or
        tensors) on ``device``, the card unless it says otherwise."""
        if isinstance(store, DenseSignatureStore):
            return {"store_sets": store.sets, "store_lengths": store.lengths}
        if isinstance(store, SignatureStore):
            csr = csr_on(store, device)
            return {"store_flat": csr.flat, "store_offsets": csr.offsets,
                    "store_lengths": csr.lengths}
        raise TypeError("lma needs a SignatureStore or DenseSignatureStore "
                        "(D')")

    @staticmethod
    def store_from_buffers(buffers: dict):
        if "store_sets" in buffers:
            return DenseSignatureStore(buffers["store_sets"],
                                       buffers["store_lengths"])
        return SignatureStore(buffers["store_flat"], buffers["store_offsets"],
                              buffers["store_lengths"])

    def locations(self, cfg, buffers, gids):
        return alc.alloc_lma(cfg.lma, self.store_from_buffers(buffers), gids)

    def memory_slots(self, cfg):
        return int(cfg.lma.m)

    def fused_spec(self, cfg):
        return fe.lma_spec(cfg.lma)

    def sparse_buckets(self, cfg):
        return cfg.lma.d if cfg.lma.stripe else 0

    def fused_inputs(self, cfg, buffers, gids):
        """D' rows (truncated to max_set, PAD where a set ends) + support for
        a flat [N] batch, gathered from either store form: the rows
        ``alloc_lma`` reads.  A local gather by global id: under a mesh the
        store holds only this rank's rows, and the sets come from the
        exchange instead (``sharded_lookup``)."""
        from repro_torch.dist.context import current_mesh
        mesh = current_mesh()
        if mesh is not None and mesh.model > 1:
            raise RuntimeError("under a mesh the D' rows come from the "
                               "exchange (sharded_lookup), not a local "
                               "gather")
        g = gids.long()
        if "store_sets" in buffers:
            rows = buffers["store_sets"][g, : cfg.lma.max_set].contiguous()
        else:
            rows = alc.csr_rows(self.store_from_buffers(buffers), g,
                                cfg.lma.max_set)
        return rows, buffers["store_lengths"][g]

    def sharded_lookup(self, cfg, params, buffers, gids, mesh):
        from repro_torch.dist import sharded_memory as sm
        if "store_flat_sh" in buffers:
            # the 'model'-sharded CSR store (shard_csr_buffers)
            return sm.sharded_lma_lookup_csr(
                params["memory"], buffers["store_flat_sh"],
                buffers["store_offsets_sh"], buffers["store_lengths"], gids,
                cfg.lma, mesh)
        if "store_sets" in buffers:
            return sm.sharded_lma_lookup(params["memory"],
                                         buffers["store_sets"],
                                         buffers["store_lengths"], gids,
                                         cfg.lma, mesh)
        # a CSR store left whole (its rows do not divide over 'model'): the
        # generic location lookup over the replicated store
        return super().sharded_lookup(cfg, params, buffers, gids, mesh)

    def extra_describe(self, cfg):
        p = cfg.lma
        return {"n_h": p.n_h, "max_set": p.max_set,
                "min_support": p.min_support, "striped": p.striped,
                "memory_init": cfg.memory_init}


# ----------------------------------------------------------------------- qr

def _qr_rows_budget(vocab: int, dim: int, budget: int,
                    total_vocab: int) -> int:
    """Row budget for one table: its proportional share of the scalar
    budget."""
    share = max(budget * (vocab / max(total_vocab, 1)), 4 * dim)
    return max(int(share // dim), 4)


def _qr_rows(vocab: int, dim: int, budget: int,
             total_vocab: int) -> tuple[int, int]:
    """(quotient rows mq, remainder rows mr) with mq + mr <= rows_budget.

    mq ~= sqrt(vocab); mr = ceil(vocab / mq) when the budget allows (then
    ``(v // mq) % mr == v // mq``: the unconstrained QR trick), else mr is
    clamped to the remaining row budget and the quotient index wraps."""
    rows_budget = _qr_rows_budget(vocab, dim, budget, total_vocab)
    mq = int(np.sqrt(max(vocab, 1)))
    mq = max(2, min(mq, rows_budget - 2))
    mr = max(2, min(-(-vocab // mq), rows_budget - mq))
    return mq, mr


@register_scheme
class QRScheme(Scheme):
    """Quotient-remainder trick: element-wise product of two small tables."""

    kind = "qr"
    family = "table"

    def param_count(self, cfg):
        self.validate(cfg)
        n = 0
        for v in cfg.vocab_sizes:
            mq, mr = _qr_rows(v, cfg.dim, cfg.budget, cfg.total_vocab)
            rows_budget = _qr_rows_budget(v, cfg.dim, cfg.budget,
                                          cfg.total_vocab)
            if mq + mr > rows_budget:
                raise ValueError(f"qr tables exceed this table's budget "
                                 f"share: vocab {v}, {mq} + {mr} rows > "
                                 f"{rows_budget}")
            n += (mq + mr) * cfg.dim
        return n

    def init_params(self, cfg, generator, device):
        self.validate(cfg)
        scale = cfg.scale_or_default()
        params = {}
        for t, v in enumerate(cfg.vocab_sizes):
            mq, mr = _qr_rows(v, cfg.dim, cfg.budget, cfg.total_vocab)
            params[f"q_{t}"] = (torch.randn((mq, cfg.dim), generator=generator,
                                            device=device) * scale
                                ).to(cfg.tdtype)
            # the remainder table multiplies element-wise: drawn around 1, so
            # the product starts near the quotient embedding
            params[f"r_{t}"] = (1.0 + torch.randn(
                (mr, cfg.dim), generator=generator, device=device) * scale
            ).to(cfg.tdtype)
        return params

    def embed_rows(self, cfg, params, table, flat_ids):
        v = flat_ids.to(torch.int32)
        q, r = params[f"q_{table}"], params[f"r_{table}"]
        eq = q[(v % q.shape[0]).long()]
        # % mr is the identity when the budget admitted mr == ceil(v / mq)
        er = r[((v // q.shape[0]) % r.shape[0]).long()]
        return eq * er


# ----------------------------------------------------------------------- md

@register_scheme
class MDScheme(Scheme):
    """Mixed-dimension tables: narrow per-table embeddings + up-projection."""

    kind = "md"
    family = "table"
    needs_budget = False

    def validate(self, cfg):
        if cfg.md_dims is None:
            raise ValueError("md needs md_dims")
        if len(cfg.md_dims) != cfg.n_tables:
            raise ValueError(f"{len(cfg.md_dims)} md_dims for "
                             f"{cfg.n_tables} tables")

    def build_config(self, vocab_sizes, dim, budget, **kw):
        if "md_dims" not in kw and budget is not None:
            kw["md_dims"] = self._dims_for_budget(tuple(vocab_sizes), dim,
                                                  budget)
        return super().build_config(vocab_sizes, dim, budget, **kw)

    @staticmethod
    def _dims_for_budget(vocab_sizes, dim, budget) -> tuple[int, ...]:
        """Per-table dims ~ proportional to each table's budget share,
        clamped to [1, dim] (mixed-dimension heuristic)."""
        total = max(sum(vocab_sizes), 1)
        dims = []
        for v in vocab_sizes:
            share = budget * (v / total)
            dims.append(int(max(1, min(dim, share // max(v + dim, 1)))))
        return tuple(dims)

    def param_count(self, cfg):
        self.validate(cfg)
        return int(sum(v * d + d * cfg.dim
                       for v, d in zip(cfg.vocab_sizes, cfg.md_dims)))

    def init_params(self, cfg, generator, device):
        self.validate(cfg)
        params = {}
        for t, (v, dt) in enumerate(zip(cfg.vocab_sizes, cfg.md_dims)):
            scale = cfg.scale_or_default(dt)
            params[f"table_{t}"] = (torch.randn(
                (v, dt), generator=generator, device=device) * scale
            ).to(cfg.tdtype)
            params[f"proj_{t}"] = (torch.randn(
                (dt, cfg.dim), generator=generator, device=device)
                / np.sqrt(dt)).to(cfg.tdtype)
        return params

    def embed_rows(self, cfg, params, table, flat_ids):
        e = params[f"table_{table}"][flat_ids.long()]
        return e @ params[f"proj_{table}"]

    def extra_describe(self, cfg):
        return {"md_dims": list(cfg.md_dims)}
