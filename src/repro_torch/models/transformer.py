"""Config-driven decoder-only transformer LM (port of
``repro.models.transformer``).

GQA or MLA attention, optional QKV bias, LayerNorm or RMSNorm, a SwiGLU FFN
or a MoE (shared + routed experts, top-k, sigmoid or softmax router) with
``first_k_dense`` leading dense layers, untied or tied output, and an
optional compressed token table: a ``repro_torch.embed``
:class:`EmbeddingTable` (the paper's LMA applied to the vocabulary), whose
lookup on the card is the fused kernel.

Where the reference stacks each layer group's parameters on a leading axis
and scans them, the port keeps one module a layer (``layers_{gi}``, an
``nn.ModuleList``; ``repro_torch.convert.lm_params_from_jax`` unstacks).
The decode cache keeps the reference's stacked layout, ``layers_{gi}`` ->
``k``, ``v`` (and ``k_scale``, ``v_scale`` for int8) of shape [count, B, L,
KV, hd], or for MLA the fused latent ``ckv`` [count, B, L, r + rope_dim]
(and ``ckv_scale`` [count, B, L]), and is written in place: ``prefill``
and ``decode_step`` assign slices of the preallocated tensors (the
reference's in-place dynamic-update-index on a loop carry); a functional
copy would double a cache that is 50 GB at tinyllama-1.1b's decode_32k
shape.

Rematerialisation, as the reference's ``jax.checkpoint``s: with
``cfg.remat`` and grad mode on, ``forward`` runs each layer's ``_block``
under ``torch.utils.checkpoint`` (non-reentrant), so a step keeps each
layer's input and recomputes its activations (the attention's score tiles
among them) in the backward; ``loss_fn`` runs each cross-entropy chunk
under one whenever grad mode is on, ``remat`` or not, so no chunk's [B,
chunk, V] float32 logits outlive it.  Values are the same with and without
it.  The recomputed regions hold no side effect: the token table's lookup
(and a sparse-gradient capture's record of it) and the output table run
once, outside them, and a MoE layer's routing is deterministic.  ``prefill``
and ``decode_step`` run under ``no_grad``, where nothing is checkpointed.

Training under an installed ``Mesh`` (the reference's ``_lm_bundle``
``train_step``): ``init(..., mesh=, train=True)`` stores every leaf as
this rank's block by ``lm_rules`` (``sharding.store_blocks``), and the
forward runs the reference's mesh layout (``dist.tensor_parallel``): a
rank's tokens are its 'data' share, replicated over 'model'; attention
and the FFNs are tensor-parallel over 'model' with their weights gathered
over the dp axes; the token table is vocab-parallel (each rank looks up
the ids in its row range and a ``psum`` over 'model' sums the rows), and
so is the cross-entropy (in each loss chunk the row max over 'model' as a
constant, the sum of exps by ``psum``, the gold logit from the rank that
owns it).  A recomputed region repeats its collectives in the same order
on every rank.  An LMA token table keeps its sharded backends.

Serving under an installed ``Mesh`` (the reference's meshed ``prefill`` /
``decode_step``): ``init(..., mesh=)`` builds a rank's share (each expert
stack's storage block, the LMA pool's 'model' slab; every dense leaf
whole), ``init_cache`` allocates the rank's slab of the cache (the batch
over ``flash_decode.plan``'s batch axes, the length over its seq axes),
``prefill`` writes only that slab, and ``decode_step`` attends through
``dist.flash_decode``.  ``prefill`` and ``decode_step`` take the cache's
whole ``length`` under a mesh (a slab does not tell it).  Tokens, hidden
states and logits are the whole batch's on every rank; the MoE layers run
``moe_apply_sharded`` (``inference``, ``lead`` = B).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import make_generator, resolve_device
from repro_torch.dist import tensor_parallel as tp
from repro_torch.embed import EmbeddingConfig, EmbeddingTable
from repro_torch.nn.attention import (GQAConfig, MLAConfig, gqa_decode,
                                      gqa_init, gqa_train, mla_decode,
                                      mla_init, mla_train, quantize_kv)
from repro_torch.nn.modules import GluFFN, LayerNorm, RMSNorm, dense
from repro_torch.nn.moe import MoEConfig, moe_dispatch, moe_init

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                      # dense FFN width (shared width for MoE)
    vocab_size: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tied_embeddings: bool = True
    attention: str = "gqa"         # gqa | mla
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    first_k_dense: int = 0         # leading dense layers before MoE layers
    dtype: str = "float32"
    remat: bool = True
    attn_block: int = 512          # KV block of the online softmax
    embedding: Optional[EmbeddingConfig] = None  # None -> full vocab table
    loss_chunk: int = 0            # 0 -> unchunked cross-entropy
    kv_cache_dtype: Optional[str] = None         # "int8" or None (dtype)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def kv_quantized(self) -> bool:
        return self.kv_cache_dtype == "int8"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def layer_groups(self) -> list[tuple[str, int]]:
        """[(kind, count)] homogeneous groups."""
        if self.moe is None:
            return [("dense", self.n_layers)]
        groups = []
        if self.first_k_dense > 0:
            groups.append(("dense", self.first_k_dense))
        groups.append(("moe", self.n_layers - self.first_k_dense))
        return groups


def _attn_cfg(cfg: TransformerConfig) -> GQAConfig:
    return GQAConfig(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                     cfg.qkv_bias, cfg.rope_theta)


def _norm(cfg: TransformerConfig, device) -> nn.Module:
    cls = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
    return cls(cfg.d_model, device, cfg.torch_dtype)


class Block(nn.Module):
    """One layer: ``norm_attn``, ``attn`` (GQA or MLA), ``norm_ffn``, and
    ``ffn`` (kind "dense") or ``moe`` (kind "moe")."""

    def __init__(self, cfg: TransformerConfig, kind: str, generator, device,
                 mesh=None):
        super().__init__()
        dt = cfg.torch_dtype
        self.kind = kind
        self.norm_attn = _norm(cfg, device)
        if cfg.attention == "mla":
            self.attn = mla_init(cfg.mla, generator, device, dt)
        else:
            self.attn = gqa_init(_attn_cfg(cfg), generator, device, dt)
        self.norm_ffn = _norm(cfg, device)
        if kind == "moe":
            self.moe = moe_init(cfg.moe, generator, device, dt, mesh)
        else:
            self.ffn = GluFFN(cfg.d_model, cfg.d_ff, generator, device,
                              dtype=dt)


class Transformer(nn.Module):
    """Parameters named as the reference's tree: ``embed`` (``table_0``, or
    the embedding scheme's parameters), ``lm_head`` (untied), ``final_norm``
    and ``layers_{gi}.{i}``.  With a mesh, a rank's share: the expert
    stacks' storage blocks and the LMA pool's 'model' slab, and with
    ``train`` every leaf's ``lm_rules`` block."""

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator,
                 device, mesh=None, train: bool = False):
        super().__init__()
        self.cfg = cfg
        dt = cfg.torch_dtype
        if cfg.embedding is None:
            scale = 1.0 / np.sqrt(cfg.d_model)
            table = torch.randn((cfg.vocab_size, cfg.d_model),
                                generator=generator, device=device) * scale
            self.embed = nn.ParameterDict({"table_0": table.to(dt)})
        else:
            self.embed = nn.ParameterDict(
                EmbeddingTable(cfg.embedding).init(generator, device, mesh))
        if not cfg.tied_embeddings:
            self.lm_head = dense(cfg.d_model, cfg.vocab_size, generator,
                                 device, bias=False, dtype=dt)
        self.final_norm = _norm(cfg, device)
        for gi, (kind, count) in enumerate(cfg.layer_groups()):
            self.add_module(f"layers_{gi}", nn.ModuleList(
                Block(cfg, kind, generator, device, mesh)
                for _ in range(count)))
        if train and mesh is not None:
            from repro_torch.dist.sharding import store_blocks
            store_blocks(self, cfg, mesh)

    def _apply(self, fn, recurse=True):
        """``Module._apply`` (``.to()``, ``.float()``, ...), each
        ``StoredBlock`` kept one where the conversion replaces it."""
        from repro_torch.dist.sharding import keep_blocks
        return keep_blocks(self, lambda: super(Transformer, self)._apply(
            fn, recurse))

    def groups(self):
        return [getattr(self, f"layers_{gi}")
                for gi in range(len(self.cfg.layer_groups()))]


def init(cfg: TransformerConfig, seed: int = 0, device=None,
         mesh=None, train: bool = False) -> Transformer:
    """Random parameters from ``seed``, on the card unless ``device`` says
    otherwise; with a mesh, this rank's share of the same parameters (to
    serve, or with ``train`` every leaf's ``lm_rules`` block)."""
    dev = resolve_device(device)
    return Transformer(cfg, make_generator(seed, dev), dev, mesh, train)


def _ffn(cfg: TransformerConfig, layer: Block, h: torch.Tensor,
         inference: bool = False):
    """The layer's FFN on h [B, S, d] -> (f [B, S, d], aux); a MoE takes
    the B * S tokens as one [T, d] batch (serving: ``inference``, with the
    batch as its ``lead``)."""
    if layer.kind == "moe":
        B, S, d = h.shape
        kw = {"inference": True, "lead": B} if inference else {}
        f, aux = moe_dispatch(layer.moe, cfg.moe, h.reshape(B * S, d), **kw)
        return f.reshape(B, S, d), aux
    return layer.ffn(h), torch.zeros((), dtype=torch.float32,
                                     device=h.device)


def _block(cfg: TransformerConfig, layer: Block, x: torch.Tensor,
           return_kv: bool = False):
    """One layer on x [B, S, d] -> (y, aux), or with ``return_kv`` (the
    prefill) (y, aux, kv)."""
    h = layer.norm_attn(x)
    if cfg.attention == "mla":
        a = mla_train(layer.attn, cfg.mla, h, block=cfg.attn_block,
                      return_kv=return_kv)
    else:
        a = gqa_train(layer.attn, _attn_cfg(cfg), h, block=cfg.attn_block,
                      return_kv=return_kv)
    if return_kv:
        a, kv = a
    x = x + a
    f, aux = _ffn(cfg, layer, layer.norm_ffn(x), inference=return_kv)
    return (x + f, aux, kv) if return_kv else (x + f, aux)


def embed_tokens(model: Transformer, cfg: TransformerConfig,
                 tokens: torch.Tensor, buffers: dict | None = None):
    """tokens [...] -> [..., d]: the full table's rows, or the embedding
    table's lookup (on the card, the fused kernel: one launch a call)."""
    if cfg.embedding is None:
        table = model.embed["table_0"]
        return tp.layout(table).rows(table, tokens)
    return EmbeddingTable(cfg.embedding).embed(dict(model.embed),
                                               buffers or {}, 0, tokens)


def _output_table(model: Transformer, cfg: TransformerConfig,
                  buffers: dict | None) -> torch.Tensor:
    """The [V, d] table the logits use."""
    if not cfg.tied_embeddings:
        return model.lm_head.weight
    if cfg.embedding is None:
        return model.embed["table_0"]
    return EmbeddingTable(cfg.embedding).materialize_rows(
        dict(model.embed), buffers or {}, 0)


def forward(model: Transformer, cfg: TransformerConfig, tokens: torch.Tensor,
            buffers: dict | None = None):
    """tokens [B, S] -> (hidden [B, S, d], aux); with ``cfg.remat`` under
    grad mode each layer is checkpointed."""
    x = embed_tokens(model, cfg, tokens, buffers).to(cfg.torch_dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for group in model.groups():
        for layer in group:
            if remat:
                x, a = checkpoint(_block, cfg, layer, x, use_reentrant=False)
            else:
                x, a = _block(cfg, layer, x)
            aux = aux + a
    return model.final_norm(x), aux


def logits_fn(model: Transformer, cfg: TransformerConfig,
              hidden: torch.Tensor, buffers: dict | None = None):
    table = _output_table(model, cfg, buffers)
    return hidden @ table.to(hidden.dtype).T


def loss_fn(model: Transformer, cfg: TransformerConfig, tokens: torch.Tensor,
            labels: torch.Tensor, buffers: dict | None = None):
    """Causal LM cross-entropy in float32; ``cfg.loss_chunk`` > 0 (and
    below S) takes it a sequence chunk at a time, so the [B, S, V] logits
    are never whole; under grad mode each chunk is checkpointed, so its
    logits are recomputed in the backward.  -> (loss, {"ce", "aux"})."""
    hidden, aux = forward(model, cfg, tokens, buffers)
    table = _output_table(model, cfg, buffers)
    lay = tp.layout(table)
    table = lay.weight(table).to(torch.float32)
    hidden = lay.enter(hidden)

    def xent(h, y):
        # vocab-parallel under a split layout: lg is this rank's [V / M]
        # logits, the row max over 'model' a constant, the sum of exps and
        # the gold logit (from the rank that owns it) summed over 'model'
        lg = h.to(torch.float32) @ table.T
        mx = lay.pmax(torch.amax(lg, dim=-1).detach())
        se = torch.sum(torch.exp(lg - mx[..., None]), dim=-1)
        se, gold = lay.leave(torch.stack([se, lay.pick(lg, y)]))
        return torch.log(se) + mx - gold

    if torch.is_grad_enabled():
        plain = xent

        def xent(h, y):
            return checkpoint(plain, h, y, use_reentrant=False)

    S = tokens.shape[1]
    if cfg.loss_chunk and cfg.loss_chunk < S:
        c = cfg.loss_chunk
        if S % c:
            raise ValueError(f"sequence {S} is not a multiple of "
                             f"loss_chunk {c}")
        losses = torch.stack([xent(hidden[:, lo:lo + c], labels[:, lo:lo + c])
                              for lo in range(0, S, c)])
        ce = torch.mean(losses)
    else:
        ce = torch.mean(xent(hidden, labels))
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


# ------------------------------------------------------------------ serving

def _cache_leaves(cfg: TransformerConfig) -> dict:
    """Each cache leaf's per-token shape: GQA's ``k``, ``v`` [KV, hd], or
    MLA's fused latent ``ckv`` [r + rope_dim]."""
    if cfg.attention == "mla":
        return {"ckv": (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_dim,)}
    return {name: (cfg.n_kv_heads, cfg.hd) for name in ("k", "v")}


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed stacked caches, ``layers_{gi}`` -> ``k``, ``v`` [count,
    batch, max_len, KV, hd], or MLA's ``ckv`` [count, batch, max_len, r +
    rope_dim]; int8 with a float32 ``{name}_scale`` (the shape without its
    last axis), else the model's dtype.  Under an installed mesh, this
    rank's slab: the rows and positions ``cache_slab`` gives."""
    dev = resolve_device(device)
    dt = torch.int8 if cfg.kv_quantized else cfg.torch_dtype
    (b0, b1), (lo, hi) = cache_slab(batch, max_len)
    cache = {}
    for gi, (_kind, count) in enumerate(cfg.layer_groups()):
        g = {}
        for name, per in _cache_leaves(cfg).items():
            shape = (count, b1 - b0, hi - lo, *per)
            g[name] = torch.zeros(shape, dtype=dt, device=dev)
            if cfg.kv_quantized:
                g[f"{name}_scale"] = torch.zeros(
                    shape[:-1], dtype=torch.float32, device=dev)
        cache[f"layers_{gi}"] = g
    return cache


def cache_slab(batch: int, max_len: int) -> tuple:
    """((b0, b1), (lo, hi)): the batch rows and positions of a [batch,
    max_len] cache this rank holds under the installed mesh
    (``flash_decode.plan``; the whole cache with no mesh, or where the
    mesh's 'model' axis does not divide the length, as decode's rule)."""
    from repro_torch.dist.context import current_mesh, dp_axes
    from repro_torch.dist.flash_decode import cache_split
    mesh = current_mesh()
    if mesh is None or max_len % mesh.model:
        return (0, batch), (0, max_len)
    return cache_split(mesh, dp_axes(mesh), batch, max_len)


def _length(cache: dict, length) -> int:
    """The whole cache's length: ``length``, or with no mesh the cache's
    own; a slab does not tell it, so a mesh needs ``length``."""
    from repro_torch.dist.context import current_mesh
    if length is not None:
        return int(length)
    if current_mesh() is not None:
        raise ValueError("under a mesh the cache is a slab: pass its whole "
                         "length")
    return int(next(iter(cache["layers_0"].values())).shape[2])


def cache_bytes_per_token(cfg: TransformerConfig) -> int:
    """Cache bytes one token of one sequence holds, over all layers: an
    int8 element a byte plus a float32 scale a row of the last axis."""
    per = 0
    for shape in _cache_leaves(cfg).values():
        n = int(np.prod(shape))
        if cfg.kv_quantized:
            per += n + 4 * (n // shape[-1])
        else:
            per += n * (torch.finfo(cfg.torch_dtype).bits // 8)
    return cfg.n_layers * per


@torch.no_grad()
def prefill(model: Transformer, cfg: TransformerConfig, tokens: torch.Tensor,
            buffers: dict | None = None, cache: dict | None = None,
            length: int | None = None):
    """tokens [B, S] -> (last-position logits [B, V], KV cache).

    Each layer's (rope'd) keys and values (quantized for an int8 cache) are
    written into rows [0, S) of ``cache``, in place; without one, a cache
    of length S is made (the reference's).  A longer cache lets a server
    decode on from the prefill without a copy: rows past S stay as given
    (zeros from ``init_cache``).  Under a mesh, only this rank's slab of a
    cache of ``length`` rows (default S without a cache) is written."""
    B, S = tokens.shape
    x = embed_tokens(model, cfg, tokens, buffers).to(cfg.torch_dtype)
    if cache is None:
        cache = init_cache(cfg, B, S, x.device)
        length = S
    L = _length(cache, length)
    (b0, b1), (lo, hi) = cache_slab(B, L)
    n = max(0, min(hi, S) - lo)             # this slab's prefilled rows
    for gi, group in enumerate(model.groups()):
        c = cache[f"layers_{gi}"]
        rows = next(iter(c.values())).shape[1:3]
        if L < S or tuple(rows) != (b1 - b0, hi - lo):
            raise ValueError(f"a cache of {tuple(rows)} cannot take a "
                             f"prefill of {(B, S)}")
        for li, layer in enumerate(group):
            x, _aux, kv = _block(cfg, layer, x, return_kv=True)
            for name, new in kv.items():
                new = new[b0:b1, lo:lo + n]
                if cfg.kv_quantized:
                    q, s = quantize_kv(new)
                    c[name][li, :, :n] = q
                    c[f"{name}_scale"][li, :, :n] = s
                else:
                    c[name][li, :, :n] = new.to(c[name].dtype)
    x = model.final_norm(x)
    return logits_fn(model, cfg, x[:, -1, :], buffers), cache


@torch.no_grad()
def decode_step(model: Transformer, cfg: TransformerConfig,
                tokens: torch.Tensor, cache: dict, cache_len: int,
                buffers: dict | None = None, length: int | None = None):
    """One decode step: tokens [B] -> (logits [B, V], cache).  The new
    token is written at ``cache_len`` (the current valid length) in place;
    the returned cache is the one given.  Under a mesh the cache is this
    rank's slab of a cache of ``length`` rows."""
    L = _length(cache, length)
    x = embed_tokens(model, cfg, tokens[:, None], buffers).to(cfg.torch_dtype)
    for gi, group in enumerate(model.groups()):
        c_full = cache[f"layers_{gi}"]
        for li, layer in enumerate(group):
            c_layer = {k: t[li] for k, t in c_full.items()}
            h = layer.norm_attn(x)
            if cfg.attention == "mla":
                a, _ = mla_decode(layer.attn, cfg.mla, h, c_layer, cache_len,
                                  block=cfg.attn_block, length=L)
            else:
                a, _ = gqa_decode(layer.attn, _attn_cfg(cfg), h, c_layer,
                                  cache_len, block=cfg.attn_block, length=L)
            x = x + a
            f, _ = _ffn(cfg, layer, layer.norm_ffn(x), inference=True)
            x = x + f
    x = model.final_norm(x)
    return logits_fn(model, cfg, x[:, 0, :], buffers), cache


def param_count(cfg: TransformerConfig) -> tuple[int, int]:
    """(total, active) parameter counts: a MoE layer's active count takes
    its top-k routed experts."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    if cfg.attention == "mla":
        m = cfg.mla
        attn = (d * m.q_lora_rank + m.q_lora_rank * cfg.n_heads * m.qk_dim
                if m.q_lora_rank else d * cfg.n_heads * m.qk_dim)
        attn += d * (m.kv_lora_rank + m.qk_rope_dim)
        attn += m.kv_lora_rank * cfg.n_heads * (m.qk_nope_dim + m.v_head_dim)
        attn += cfg.n_heads * m.v_head_dim * d
    else:
        attn = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
                + cfg.n_heads * hd * d)
    emb = cfg.vocab_size * d * (1 if cfg.tied_embeddings else 2)
    total = active = emb
    for kind, count in cfg.layer_groups():
        if kind == "dense":
            total += count * (attn + 3 * d * f)
            active += count * (attn + 3 * d * f)
        else:
            mo = cfg.moe
            expert = 3 * d * mo.d_ff
            shared = 3 * d * mo.d_ff * mo.n_shared_experts
            router = d * mo.n_experts
            total += count * (attn + mo.n_experts * expert + shared + router)
            active += count * (attn + mo.top_k * expert + shared + router)
    return int(total), int(active)
