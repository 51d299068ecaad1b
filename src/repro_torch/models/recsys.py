"""RecSys / CTR models: the DLRM and xDeepFM branches of
``repro.models.recsys``.

The categorical features come through one :class:`EmbeddingTable` (LMA or a
baseline, by ``EmbeddingConfig.kind``) with one common memory across all
fields; xDeepFM's first-order term is a second, d=1 table over the same
fields and buffers.  DCN-v2 and DIN come in later slices.

Batch format (dict of tensors):
  dense   [B, n_dense]  float32 (DLRM; xDeepFM has none and ignores it)
  sparse  [B, n_fields] int32   (field-local ids)
  label   [B]           float32 (``loss_fn`` only)
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.device import make_generator, resolve_device
from repro_torch.embed import EmbeddingConfig, EmbeddingTable
from repro_torch.kernels.cin.ops import cin
from repro_torch.kernels.dot_interaction.ops import dot_interaction
from repro_torch.nn.modules import MLP, dense


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    model: str                     # dlrm | xdeepfm (dcn | din: later slices)
    embedding: EmbeddingConfig
    n_dense: int = 0
    # dlrm
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
    # xdeepfm (deep_mlp is DCN's too, in the reference)
    deep_mlp: tuple[int, ...] = ()
    cin_layers: tuple[int, ...] = ()
    dtype: str = "float32"

    @property
    def n_fields(self) -> int:
        return self.embedding.n_tables

    @property
    def table(self) -> EmbeddingTable:
        return EmbeddingTable(self.embedding)

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def d_interaction(self) -> int:
        """Top-MLP input: the F+1 features' pair dots + the bottom output."""
        n_feats = self.n_fields + 1
        return n_feats * (n_feats - 1) // 2 + self.bot_mlp[-1]


def linear_config(cfg: RecsysConfig) -> EmbeddingConfig:
    """xDeepFM's first-order table: the embedding's scheme at d=1 with a
    budget of m // d (at least 4096, rounded up to a multiple of 4096).  Its
    LMA parameters keep every other field of the main pool's, ``striped``
    included, as the reference's ``_linear_cfg`` does."""
    e = cfg.embedding
    if e.kind == "full":
        return dataclasses.replace(e, dim=1, budget=None, lma=None)
    m_lin = max(e.budget // max(e.dim, 1), 4096)
    m_lin = -(-m_lin // 4096) * 4096
    return dataclasses.replace(
        e, dim=1, budget=m_lin,
        lma=None if e.lma is None else
        dataclasses.replace(e.lma, d=1, m=m_lin))


class Recsys(nn.Module):
    """DLRM: bottom MLP on dense features, pairwise dot interaction of the
    bottom output with the field embeddings, top MLP -> logits [B].

    xDeepFM: a CIN over the field embeddings (each layer ReLU'd and summed
    over d into a pool, the pools through ``cin_out``), a deep MLP over the
    flattened embeddings, and the linear table's field sum; the three
    logits added."""

    def __init__(self, cfg: RecsysConfig,
                 generator: torch.Generator | None = None, device=None,
                 mesh=None):
        """``mesh`` (``repro_torch.dist``): keep only this rank's slab of
        each pool; everything else is drawn and held whole, as on one
        device."""
        super().__init__()
        if cfg.model not in ("dlrm", "xdeepfm"):
            raise NotImplementedError(f"{cfg.model}: not ported yet")
        dev = resolve_device(device)
        gen = make_generator(0, dev) if generator is None else generator
        self.cfg = cfg
        self.embedding = nn.ParameterDict(cfg.table.init(gen, dev, mesh))
        if cfg.model == "dlrm":
            self.bot = MLP([cfg.n_dense, *cfg.bot_mlp], gen, dev,
                           final_act=torch.relu, dtype=cfg.tdtype)
            self.top = MLP([cfg.d_interaction, *cfg.top_mlp], gen, dev,
                           dtype=cfg.tdtype)
            return
        F, d = cfg.n_fields, cfg.embedding.dim
        self.cin = nn.ParameterDict()
        hk = F
        for i, ho in enumerate(cfg.cin_layers):
            w = torch.randn((ho, hk, F), generator=gen, device=dev) \
                / np.sqrt(hk * F)
            self.cin[f"layer_{i}"] = nn.Parameter(w.to(cfg.tdtype))
            hk = ho
        self.cin_out = dense(sum(cfg.cin_layers), 1, gen, dev,
                             dtype=cfg.tdtype)
        self.deep = MLP([F * d, *cfg.deep_mlp, 1], gen, dev, dtype=cfg.tdtype)
        self.linear_table = EmbeddingTable(linear_config(cfg))
        self.linear = nn.ParameterDict(self.linear_table.init(gen, dev,
                                                              mesh))

    def forward(self, batch: dict, buffers: dict | None = None
                ) -> torch.Tensor:
        cfg = self.cfg
        buffers = buffers or {}
        feats = cfg.table.embed_fields(dict(self.embedding), buffers,
                                       batch["sparse"])            # [B, F, d]
        if cfg.model == "xdeepfm":
            return self._xdeepfm(feats, batch, buffers)
        bot = self.bot(batch["dense"].to(cfg.tdtype))                # [B, d]
        allf = torch.cat([bot[:, None, :], feats], dim=1).contiguous()
        z = dot_interaction(allf)
        return self.top(torch.cat([bot, z], dim=-1))[:, 0]

    def _xdeepfm(self, feats, batch, buffers):
        B = feats.shape[0]
        x0 = feats.contiguous()
        xk = x0
        pools = []
        for i in range(len(self.cfg.cin_layers)):
            xk = torch.relu(cin(xk, x0, self.cin[f"layer_{i}"]))
            pools.append(torch.sum(xk, dim=-1))                      # [B, Ho]
        cin_logit = self.cin_out(torch.cat(pools, dim=-1))[:, 0]
        deep_logit = self.deep(feats.reshape(B, -1))[:, 0]
        lin = self.linear_table.embed_fields(dict(self.linear), buffers,
                                             batch["sparse"])        # [B, F, 1]
        lin_logit = torch.sum(lin, dim=(1, 2))
        return cin_logit + deep_logit + lin_logit


def lookups_per_example(cfg: RecsysConfig) -> int:
    """Embedding-row lookups one example performs: one per field (the unit
    of the trainer's lookups_per_sec; as in the reference, xDeepFM's linear
    table lookups are not counted)."""
    return cfg.n_fields


def init(cfg: RecsysConfig, generator: torch.Generator | None = None,
         device=None, mesh=None) -> Recsys:
    return Recsys(cfg, generator, device, mesh)


def loss_fn(model: Recsys, batch: dict, buffers: dict | None = None):
    """Numerically stable BCE-with-logits -> (loss, {"ce", "logits"})."""
    logits = model(batch, buffers).to(torch.float32)
    y = batch["label"].to(torch.float32)
    ce = torch.mean(torch.clamp(logits, min=0) - logits * y
                    + torch.log1p(torch.exp(-torch.abs(logits))))
    return ce, {"ce": ce, "logits": logits}
