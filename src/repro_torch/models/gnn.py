"""Graph attention network (GAT, Velickovic et al. 2018) over an edge list
(port of ``repro.models.gnn``).

Message passing runs over an edge-index representation: per-edge attention
logits (SDDMM), a softmax over each destination's incoming edges and a
scatter-add aggregation (SpMM).  The reference forms one [E, H, D] message
tensor; at ogbn-products' 126,167,309 symmetrised edges and its output
layer (8 heads x 47 classes) that tensor alone is 190 GB in float32, so the
port aggregates a chunk of edges at a time, forward and backward, and keeps
only node-level tensors (``_EdgeSoftmax``).  ``gat_conv_plain`` is the
reference's formula in plain autograd, unchunked: the tests and the card's
smoke run hold the chunked layer against it.

Supports: full-batch graphs (Cora, ogbn-products scale), sampled minibatch
blocks (``repro_torch.data.graph``; padded edges masked by ``edge_mask``),
and batched small molecule graphs (block-diagonal edges, mean readout).
``GATConfig.node_id_embedding`` draws node inputs from an
:class:`EmbeddingTable` (for LMA: the fused lookup on the card) instead of
a feature matrix.

Batch format (dict of tensors): ``features`` [N, F] float32 or
``node_ids`` [N] int32; ``src``, ``dst`` [E] int32; optional ``edge_mask``
[E] bool; ``labels`` [N] (or [G]) and optional ``label_mask`` [N] bool
(``loss_fn`` only); for the mean readout ``graph_ids`` [N] and
``n_graphs``.  The reference's sharding hints are layout only: one card has
no mesh, so they are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.device import make_generator, resolve_device
from repro_torch.embed import EmbeddingConfig, EmbeddingTable
from repro_torch.nn.modules import MLP

# one [C, H, D] transient of the chunked aggregation holds about this many
# bytes (the backward keeps two alive at once)
CHUNK_BYTES = 1 << 30
MASKED = -1e30       # a padded edge's logit
EMPTY = -1e29        # a segment max at or below this: no live in-edge
DENOM_MIN = 1e-9


@dataclasses.dataclass(frozen=True)
class GATConfig:
    d_in: int
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    n_classes: int = 7
    negative_slope: float = 0.2
    readout: Optional[str] = None      # None (node-level) | "mean" (graph-level)
    node_id_embedding: Optional[EmbeddingConfig] = None
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def edge_chunk(n_heads: int, d: int, itemsize: int = 4) -> int:
    """Edges a chunk takes so that one [C, H, D] transient is about
    ``CHUNK_BYTES``."""
    return max(1, CHUNK_BYTES // (n_heads * d * itemsize))


def _edge_logits(logit_src, logit_dst, s, d, m, slope: float):
    """A chunk's leaky-ReLU'd logits [C, H] (padded edges at -1e30) and
    their pre-activation sums."""
    raw = logit_src[s] + logit_dst[d]
    e = torch.where(raw >= 0, raw, slope * raw)
    if m is not None:
        e = torch.where(m[:, None], e, MASKED)
    return e, raw


def _edge_p(e, emax, d, m):
    """A chunk's unnormalised attention exp(e - emax[dst]) [C, H], padded
    edges 0."""
    p = torch.exp(e - emax[d])
    return p * m[:, None] if m is not None else p


def _spans(n_edges: int, chunk: int):
    return ((lo, min(lo + chunk, n_edges)) for lo in range(0, n_edges, chunk))


class _EdgeSoftmax(torch.autograd.Function):
    """out[v] = sum_{i: dst_i = v} p_i h[src_i] / max(sum p_i, 1e-9), with
    p_i = exp(e_i - emax[v]) over edge chunks.

    Forward: a segment max of the logits into ``emax`` [N, H], then, with
    p per chunk, ``denom`` += p and ``agg`` += p h[src] by ``index_add_``.
    Backward recomputes e and p chunk by chunk: g_agg = g_out / q (q the
    clamped denominator), g_denom = -sum_D g_out agg / q^2 where denom >
    1e-9; per edge g_p = sum_D g_agg[dst] h[src] + g_denom[dst], g_e = g_p p,
    g_raw = g_e (1 where raw >= 0, else the slope); those go into the node
    tensors by ``index_add_``.  ``emax`` is a constant: the softmax does not
    depend on the shift in arithmetic.  Saved: node-level tensors only."""

    @staticmethod
    def forward(ctx, h, logit_src, logit_dst, src, dst, mask, slope, chunk):
        N, H, D = h.shape
        E = src.shape[0]
        emax = torch.full((N, H), float("-inf"), dtype=h.dtype,
                          device=h.device)
        for lo, hi in _spans(E, chunk):
            d = dst[lo:hi]
            m = mask[lo:hi] if mask is not None else None
            e, _ = _edge_logits(logit_src, logit_dst, src[lo:hi], d, m, slope)
            emax.scatter_reduce_(0, d.long()[:, None].expand(-1, H), e,
                                 "amax")
        emax = torch.where(emax > EMPTY, emax, 0.0)
        denom = torch.zeros((N, H), dtype=h.dtype, device=h.device)
        agg = torch.zeros_like(h)
        for lo, hi in _spans(E, chunk):
            s, d = src[lo:hi], dst[lo:hi]
            m = mask[lo:hi] if mask is not None else None
            e, _ = _edge_logits(logit_src, logit_dst, s, d, m, slope)
            p = _edge_p(e, emax, d, m)
            denom.index_add_(0, d, p)
            agg.index_add_(0, d, h[s].mul_(p[..., None]))
        ctx.save_for_backward(h, logit_src, logit_dst, src, dst, mask, emax,
                              denom, agg)
        ctx.slope, ctx.chunk = slope, chunk
        return agg / torch.clamp(denom, min=DENOM_MIN)[..., None]

    @staticmethod
    def backward(ctx, g_out):
        h, logit_src, logit_dst, src, dst, mask, emax, denom, agg = \
            ctx.saved_tensors
        slope = ctx.slope
        q = torch.clamp(denom, min=DENOM_MIN)
        g_agg = g_out / q[..., None]
        g_denom = torch.where(denom > DENOM_MIN,
                              -torch.sum(g_out * agg, dim=-1) / (q * q), 0.0)
        g_h = torch.zeros_like(h)
        g_src = torch.zeros_like(logit_src)
        g_dst = torch.zeros_like(logit_dst)
        for lo, hi in _spans(src.shape[0], ctx.chunk):
            s, d = src[lo:hi], dst[lo:hi]
            m = mask[lo:hi] if mask is not None else None
            e, raw = _edge_logits(logit_src, logit_dst, s, d, m, slope)
            p = _edge_p(e, emax, d, m)
            ga = g_agg[d]                                        # [C, H, D]
            g_p = torch.sum(h[s].mul_(ga), dim=-1) + g_denom[d]
            g_raw = g_p * p * torch.where(raw >= 0, 1.0, slope)
            g_src.index_add_(0, s, g_raw)
            g_dst.index_add_(0, d, g_raw)
            g_h.index_add_(0, s, ga.mul_(p[..., None]))
        return g_h, g_src, g_dst, None, None, None, None, None


def _project(p, x):
    """x [N, F] -> h [N, H, D] and the two logits [N, H]."""
    w = p["w"]
    F, H, D = w.shape
    h = torch.matmul(x, w.reshape(F, H * D)).reshape(x.shape[0], H, D)
    logit_src = torch.sum(h * p["a_src"][None], dim=-1)
    logit_dst = torch.sum(h * p["a_dst"][None], dim=-1)
    return h, logit_src, logit_dst


def _heads(out: torch.Tensor, concat_heads: bool) -> torch.Tensor:
    return out.reshape(out.shape[0], -1) if concat_heads \
        else torch.mean(out, dim=1)


def gat_conv(p, x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
             n_nodes: int, *, negative_slope: float, concat_heads: bool,
             edge_mask: torch.Tensor | None = None,
             chunk: int | None = None) -> torch.Tensor:
    """x [N, F] -> [N, H*D] (concat) or [N, D] (head mean, output layer),
    aggregated ``chunk`` edges at a time (default: ``edge_chunk``'s, from
    bytes)."""
    h, logit_src, logit_dst = _project(p, x)
    if chunk is None:
        chunk = edge_chunk(h.shape[1], h.shape[2], h.element_size())
    if h.shape[0] != n_nodes:
        raise ValueError(f"{h.shape[0]} node rows for {n_nodes} nodes")
    out = _EdgeSoftmax.apply(h, logit_src, logit_dst, src, dst, edge_mask,
                             float(negative_slope), int(chunk))
    return _heads(out, concat_heads)


def gat_conv_plain(p, x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   n_nodes: int, *, negative_slope: float,
                   concat_heads: bool,
                   edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's ``gat_conv`` in plain autograd: one [E, H, D]
    message tensor, gradients through the segment max too."""
    h, logit_src, logit_dst = _project(p, x)
    H = h.shape[1]
    e, _ = _edge_logits(logit_src, logit_dst, src, dst, edge_mask,
                        negative_slope)
    emax = torch.full((n_nodes, H), float("-inf"), dtype=h.dtype,
                      device=h.device).scatter_reduce(
        0, dst.long()[:, None].expand(-1, H), e, "amax")
    emax = torch.where(emax > EMPTY, emax, 0.0)
    p_edge = _edge_p(e, emax, dst, edge_mask)
    denom = torch.zeros((n_nodes, H), dtype=h.dtype,
                        device=h.device).index_add(0, dst, p_edge)
    msg = p_edge[..., None] * h[src]
    agg = torch.zeros_like(h).index_add(0, dst, msg)
    return _heads(agg / torch.clamp(denom, min=DENOM_MIN)[..., None],
                  concat_heads)


class GAT(nn.Module):
    """``layer_{i}`` (``w`` [d_prev, H, D], ``a_src`` and ``a_dst`` [H, D]),
    ELU between layers; concatenated heads on every layer but a node-level
    output layer, which takes the head mean; with a readout, the ``head``
    MLP over each graph's mean; ``node_embed`` when node ids are the
    input."""

    def __init__(self, cfg: GATConfig,
                 generator: torch.Generator | None = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = make_generator(0, dev) if generator is None else generator
        self.cfg = cfg
        d_prev = cfg.d_in
        for li in range(cfg.n_layers):
            last = li == cfg.n_layers - 1
            d_out = cfg.n_classes if (last and cfg.readout is None) \
                else cfg.d_hidden
            s = 1.0 / np.sqrt(d_prev)

            def draw(*shape):
                return nn.Parameter((torch.randn(
                    shape, generator=gen, device=dev) * s).to(cfg.tdtype))
            self.add_module(f"layer_{li}", nn.ParameterDict({
                "w": draw(d_prev, cfg.n_heads, d_out),
                "a_src": draw(cfg.n_heads, d_out),
                "a_dst": draw(cfg.n_heads, d_out)}))
            d_prev = d_out if (last and cfg.readout is None) \
                else d_out * cfg.n_heads
        if cfg.readout is not None:
            self.head = MLP([d_prev, cfg.d_hidden * cfg.n_heads,
                             cfg.n_classes], gen, dev)
        if cfg.node_id_embedding is not None:
            self.node_embed = nn.ParameterDict(
                EmbeddingTable(cfg.node_id_embedding).init(gen, dev))

    def forward(self, batch: dict, buffers: dict | None = None,
                chunk: int | None = None, plain: bool = False
                ) -> torch.Tensor:
        """-> logits [N, n_classes] (node-level) or [G, n_classes] (mean
        readout).  ``chunk``: edges a chunk of every layer (default from
        bytes, per layer); ``plain``: ``gat_conv_plain`` instead."""
        cfg = self.cfg
        if cfg.node_id_embedding is not None:
            x = EmbeddingTable(cfg.node_id_embedding).embed(
                dict(self.node_embed), buffers or {}, 0, batch["node_ids"])
        else:
            x = batch["features"].to(cfg.tdtype)
        src, dst = batch["src"], batch["dst"]
        n = x.shape[0]
        mask = batch.get("edge_mask")
        for li in range(cfg.n_layers):
            last = li == cfg.n_layers - 1
            kw = dict(negative_slope=cfg.negative_slope,
                      concat_heads=not (last and cfg.readout is None),
                      edge_mask=mask)
            p = getattr(self, f"layer_{li}")
            x = gat_conv_plain(p, x, src, dst, n, **kw) if plain \
                else gat_conv(p, x, src, dst, n, chunk=chunk, **kw)
            if not last:
                x = torch.nn.functional.elu(x)
        if cfg.readout == "mean":
            g = batch["graph_ids"]
            ng = int(batch["n_graphs"])
            summed = torch.zeros((ng, x.shape[1]), dtype=x.dtype,
                                 device=x.device).index_add(0, g, x)
            count = torch.zeros((ng, 1), dtype=x.dtype,
                                device=x.device).index_add(
                0, g, torch.ones((n, 1), dtype=x.dtype, device=x.device))
            return self.head(summed / torch.clamp(count, min=1.0))
        return x


def init(cfg: GATConfig, generator: torch.Generator | None = None,
         device=None) -> GAT:
    return GAT(cfg, generator, device)


def loss_fn(model: GAT, batch: dict, buffers: dict | None = None,
            chunk: int | None = None, plain: bool = False):
    """Masked mean cross-entropy and accuracy -> (ce, {"ce", "acc"})."""
    logits = model(batch, buffers, chunk, plain)
    labels = batch["labels"].long()
    mask = batch.get("label_mask")
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    hit = torch.argmax(logits, dim=-1) == labels
    if mask is not None:
        count = torch.clamp(torch.sum(mask), min=1)
        ce = torch.sum(torch.where(mask, nll, 0.0)) / count
        acc = torch.sum(hit & mask) / count
    else:
        ce = torch.mean(nll)
        acc = torch.mean(hit.to(torch.float32))
    return ce, {"ce": ce, "acc": acc}
