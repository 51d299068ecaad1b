"""RecSys / CTR models (port of ``repro.models.recsys``): DLRM, DCN-v2,
xDeepFM and DIN.

The categorical features come through one :class:`EmbeddingTable` (LMA or a
baseline, by ``EmbeddingConfig.kind``) with one common memory across all
fields; xDeepFM's first-order term is a second, d=1 table over the same
fields and buffers.  DIN's history and candidate are ids of one item table,
looked up history first.

Batch format (dict of tensors):
  dense      [B, n_dense]  float32 (DLRM, DCN; xDeepFM and DIN have none)
  sparse     [B, n_fields] int32   (field-local ids)
  hist       [B, L]        int32   (DIN behaviour sequence, item ids)
  hist_mask  [B, L]        bool
  target     [B]           int32   (DIN candidate item)
  label      [B]           float32 (``loss_fn`` only)

Serving: ``Recsys.forward`` -> logits [B]; ``retrieval`` -> scores of one
context against [C] candidates, scanned in chunks.
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
    model: str                     # dlrm | dcn | xdeepfm | din
    embedding: EmbeddingConfig
    n_dense: int = 0
    # dlrm (top_mlp is DIN's head too)
    bot_mlp: tuple[int, ...] = ()
    top_mlp: tuple[int, ...] = ()
    # dcn (deep_mlp is xDeepFM's too)
    n_cross_layers: int = 0
    deep_mlp: tuple[int, ...] = ()
    # xdeepfm
    cin_layers: tuple[int, ...] = ()
    # din
    hist_len: int = 0
    attn_mlp: tuple[int, ...] = ()
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

    DCN-v2: x0 = the flattened field embeddings and the dense features;
    full-rank cross layers x <- x0 * (W x + b) + x beside a ReLU deep MLP
    on x0, both into a linear head.

    xDeepFM: a CIN over the field embeddings (each layer ReLU'd and summed
    over d into a pool, the pools through ``cin_out``), a deep MLP over the
    flattened embeddings, and the linear table's field sum; the three
    logits added.

    DIN: target attention over the history (a sigmoid MLP on [h, t, h - t,
    h * t], no softmax, masked weights), the weighted sum of the history
    beside the target and their product through a ReLU head."""

    def __init__(self, cfg: RecsysConfig,
                 generator: torch.Generator | None = None, device=None,
                 mesh=None):
        """``mesh`` (``repro_torch.dist``): keep only this rank's slab of
        each pool; everything else is drawn and held whole, as on one
        device."""
        super().__init__()
        if cfg.model not in ("dlrm", "dcn", "xdeepfm", "din"):
            raise ValueError(f"unknown recsys model {cfg.model!r}")
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
        if cfg.model == "dcn":
            d_x0 = F * d + cfg.n_dense
            self.cross = nn.ModuleDict({
                f"layer_{i}": dense(d_x0, d_x0, gen, dev, dtype=cfg.tdtype)
                for i in range(cfg.n_cross_layers)})
            self.deep = MLP([d_x0, *cfg.deep_mlp], gen, dev,
                            final_act=torch.relu, dtype=cfg.tdtype)
            self.head = dense(d_x0 + cfg.deep_mlp[-1], 1, gen, dev,
                              dtype=cfg.tdtype)
            return
        if cfg.model == "din":
            self.att = MLP([4 * d, *cfg.attn_mlp, 1], gen, dev,
                           act=torch.sigmoid, dtype=cfg.tdtype)
            self.head = MLP([3 * d + cfg.n_dense, *cfg.top_mlp, 1], gen, dev,
                            dtype=cfg.tdtype)
            return
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
        if cfg.model == "din":
            return self._din(batch, buffers)
        feats = cfg.table.embed_fields(dict(self.embedding), buffers,
                                       batch["sparse"])            # [B, F, d]
        if cfg.model == "xdeepfm":
            return self._xdeepfm(feats, batch, buffers)
        if cfg.model == "dcn":
            return self.dcn_logits(feats, batch)
        bot = self.bot(batch["dense"].to(cfg.tdtype))                # [B, d]
        allf = torch.cat([bot[:, None, :], feats], dim=1).contiguous()
        z = dot_interaction(allf)
        return self.top(torch.cat([bot, z], dim=-1))[:, 0]

    def dcn_logits(self, feats, batch):
        """DCN-v2's logits from the field embeddings [B, F, d]."""
        x0 = torch.cat([feats.reshape(feats.shape[0], -1),
                        batch["dense"].to(self.cfg.tdtype)], dim=-1)
        x = x0
        for i in range(self.cfg.n_cross_layers):
            x = x0 * self.cross[f"layer_{i}"](x) + x
        deep = self.deep(x0)
        return self.head(torch.cat([x, deep], dim=-1))[:, 0]

    def _din(self, batch, buffers):
        cfg, emb = self.cfg, dict(self.embedding)
        e_hist = cfg.table.embed(emb, buffers, 0, batch["hist"])    # [B, L, d]
        e_t = cfg.table.embed(emb, buffers, 0, batch["target"])     # [B, d]
        return self.din_logits(e_hist, e_t, batch)

    def din_logits(self, e_hist, e_t, batch):
        """DIN's logits from the looked-up history [B, L, d] and target
        [B, d]: the target attention, the pooled history, the head."""
        cfg = self.cfg
        et_b = e_t[..., None, :].expand_as(e_hist)
        att_in = torch.cat([e_hist, et_b, e_hist - et_b, e_hist * et_b],
                           dim=-1)
        w = self.att(att_in)[..., 0]                                # [B, L]
        w = torch.where(batch["hist_mask"], w, 0.0)
        pooled = torch.einsum("...l,...ld->...d", w, e_hist)
        head_in = [pooled, e_t, pooled * e_t]
        if cfg.n_dense:
            head_in.append(batch["dense"].to(cfg.tdtype))
        return self.head(torch.cat(head_in, dim=-1))[:, 0]

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
    """Embedding-row lookups one example performs: DIN's history and its
    target, else one per field (the unit of the trainer's lookups_per_sec;
    as in the reference, xDeepFM's linear table lookups are not counted)."""
    return (cfg.hist_len + 1) if cfg.model == "din" else cfg.n_fields


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


def retrieval(model: Recsys, batch: dict, candidates: torch.Tensor,
              buffers: dict | None = None, chunk: int = 8192
              ) -> torch.Tensor:
    """Score one context against ``candidates`` [C] item ids -> [C], in
    chunks of ``chunk`` (the last padded with id 0 and sliced off), so no
    [C, ...] block is ever formed; without autograd.  For DIN the candidate
    replaces ``target`` (``batch``: ``hist`` and ``hist_mask`` [1, L]); for
    the field models it replaces field 0, the item field by convention
    (``batch``: ``sparse`` [1, F] and ``dense`` [1, n_dense])."""
    cfg = model.cfg
    C = candidates.shape[0]
    nc = -(-C // chunk)
    cand = torch.zeros(nc * chunk, dtype=candidates.dtype,
                       device=candidates.device)
    cand[:C] = candidates
    scores = []

    def rep(a):
        return a.expand(chunk, *a.shape[1:])

    with torch.no_grad():
        for cand_c in cand.split(chunk):
            if cfg.model == "din":
                b = {"hist": rep(batch["hist"]),
                     "hist_mask": rep(batch["hist_mask"]), "target": cand_c}
            else:
                sparse = rep(batch["sparse"]).clone()
                sparse[:, 0] = cand_c
                b = {"sparse": sparse}
            if cfg.n_dense:
                b["dense"] = rep(batch["dense"])
            scores.append(model(b, buffers))
    return torch.cat(scores)[:C]
