"""RecSys / CTR models: the DLRM branch of ``repro.models.recsys``.

The categorical features come through one :class:`EmbeddingTable` (LMA or a
baseline, by ``EmbeddingConfig.kind``) with one common memory across all
fields.  DCN-v2, xDeepFM and DIN come in later slices.

Batch format (dict of tensors):
  dense   [B, n_dense]  float32
  sparse  [B, n_fields] int32   (field-local ids)
  label   [B]           float32 (``loss_fn`` only)
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.device import make_generator, resolve_device
from repro_torch.embed import EmbeddingConfig, EmbeddingTable
from repro_torch.kernels.dot_interaction.ops import dot_interaction
from repro_torch.nn.modules import MLP


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    model: str                     # dlrm (dcn | xdeepfm | din: later slices)
    embedding: EmbeddingConfig
    n_dense: int = 0
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
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


class Recsys(nn.Module):
    """DLRM: bottom MLP on dense features, pairwise dot interaction of the
    bottom output with the field embeddings, top MLP -> logits [B]."""

    def __init__(self, cfg: RecsysConfig,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        if cfg.model != "dlrm":
            raise NotImplementedError(f"{cfg.model}: not ported yet")
        dev = resolve_device(device)
        gen = make_generator(0, dev) if generator is None else generator
        self.cfg = cfg
        self.embedding = nn.ParameterDict(cfg.table.init(gen, dev))
        self.bot = MLP([cfg.n_dense, *cfg.bot_mlp], gen, dev,
                       final_act=torch.relu, dtype=cfg.tdtype)
        self.top = MLP([cfg.d_interaction, *cfg.top_mlp], gen, dev,
                       dtype=cfg.tdtype)

    def forward(self, batch: dict, buffers: dict | None = None
                ) -> torch.Tensor:
        cfg = self.cfg
        feats = cfg.table.embed_fields(dict(self.embedding), buffers or {},
                                       batch["sparse"])            # [B, F, d]
        bot = self.bot(batch["dense"].to(cfg.tdtype))                # [B, d]
        allf = torch.cat([bot[:, None, :], feats], dim=1).contiguous()
        z = dot_interaction(allf)
        return self.top(torch.cat([bot, z], dim=-1))[:, 0]


def lookups_per_example(cfg: RecsysConfig) -> int:
    """Embedding-row lookups one example performs: one per field for DLRM
    (the unit of the trainer's lookups_per_sec)."""
    return cfg.n_fields


def init(cfg: RecsysConfig, generator: torch.Generator | None = None,
         device=None) -> Recsys:
    return Recsys(cfg, generator, device)


def loss_fn(model: Recsys, batch: dict, buffers: dict | None = None):
    """Numerically stable BCE-with-logits -> (loss, {"ce", "logits"})."""
    logits = model(batch, buffers).to(torch.float32)
    y = batch["label"].to(torch.float32)
    ce = torch.mean(torch.clamp(logits, min=0) - logits * y
                    + torch.log1p(torch.exp(-torch.abs(logits))))
    return ce, {"ce": ce, "logits": logits}
