"""Config-driven decoder-only transformer LM, the dense path (port of
``repro.models.transformer``).

GQA attention, optional QKV bias, LayerNorm or RMSNorm, SwiGLU FFN, untied
or tied output, and an optional compressed token table: a
``repro_torch.embed`` :class:`EmbeddingTable` (the paper's LMA applied to
the vocabulary), whose lookup on the card is the fused kernel.  MoE and MLA
configs are refused (``LATER``).

Where the reference stacks each layer group's parameters on a leading axis
and scans them, the port keeps one module a layer (``layers_{gi}``, an
``nn.ModuleList``; ``repro_torch.convert.lm_params_from_jax`` unstacks).
The decode cache keeps the reference's stacked layout, ``layers_{gi}`` ->
``k``, ``v`` (and ``k_scale``, ``v_scale`` for int8) of shape [count, B, L,
KV, hd], and is written in place: ``prefill`` and ``decode_step`` assign
slices of the preallocated tensors (the reference's in-place
dynamic-update-index on a loop carry); a functional copy would double a
cache that is 50 GB at tinyllama-1.1b's decode_32k shape.  ``remat`` has no
effect here (serving keeps no activations for a backward; the training
path is autograd's default).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.device import make_generator, resolve_device
from repro_torch.embed import EmbeddingConfig, EmbeddingTable
from repro_torch.nn.attention import (LATER, GQAConfig, gqa_decode,
                                      gqa_init, gqa_train, quantize_kv)
from repro_torch.nn.modules import GluFFN, LayerNorm, RMSNorm, dense

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                      # dense FFN width
    vocab_size: int
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    tied_embeddings: bool = True
    attention: str = "gqa"         # gqa (mla: not ported yet)
    mla: Optional[Any] = None
    moe: Optional[Any] = None
    first_k_dense: int = 0
    dtype: str = "float32"
    remat: bool = True
    attn_block: int = 512          # KV block of the online softmax
    embedding: Optional[EmbeddingConfig] = None  # None -> full vocab table
    loss_chunk: int = 0            # 0 -> unchunked cross-entropy
    kv_cache_dtype: Optional[str] = None         # "int8" or None (dtype)

    def __post_init__(self):
        if self.moe is not None or self.attention != "gqa":
            raise NotImplementedError(
                f"{self.name}: MoE and MLA layers are {LATER}")

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
        """[(kind, count)] homogeneous groups: one dense group."""
        return [("dense", self.n_layers)]


def _attn_cfg(cfg: TransformerConfig) -> GQAConfig:
    return GQAConfig(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                     cfg.qkv_bias, cfg.rope_theta)


def _norm(cfg: TransformerConfig, device) -> nn.Module:
    cls = RMSNorm if cfg.norm == "rmsnorm" else LayerNorm
    return cls(cfg.d_model, device, cfg.torch_dtype)


class Block(nn.Module):
    """One dense layer: ``norm_attn``, ``attn``, ``norm_ffn``, ``ffn``."""

    def __init__(self, cfg: TransformerConfig, generator, device):
        super().__init__()
        dt = cfg.torch_dtype
        self.norm_attn = _norm(cfg, device)
        self.attn = gqa_init(_attn_cfg(cfg), generator, device, dt)
        self.norm_ffn = _norm(cfg, device)
        self.ffn = GluFFN(cfg.d_model, cfg.d_ff, generator, device, dtype=dt)


class Transformer(nn.Module):
    """Parameters named as the reference's tree: ``embed`` (``table_0``, or
    the embedding scheme's parameters), ``lm_head`` (untied), ``final_norm``
    and ``layers_{gi}.{i}``."""

    def __init__(self, cfg: TransformerConfig, generator: torch.Generator,
                 device):
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
                EmbeddingTable(cfg.embedding).init(generator, device))
        if not cfg.tied_embeddings:
            self.lm_head = dense(cfg.d_model, cfg.vocab_size, generator,
                                 device, bias=False, dtype=dt)
        self.final_norm = _norm(cfg, device)
        for gi, (_kind, count) in enumerate(cfg.layer_groups()):
            self.add_module(f"layers_{gi}", nn.ModuleList(
                Block(cfg, generator, device) for _ in range(count)))

    def groups(self):
        return [getattr(self, f"layers_{gi}")
                for gi in range(len(self.cfg.layer_groups()))]


def init(cfg: TransformerConfig, seed: int = 0, device=None) -> Transformer:
    """Random parameters from ``seed``, on the card unless ``device`` says
    otherwise."""
    dev = resolve_device(device)
    return Transformer(cfg, make_generator(seed, dev), dev)


def _block(cfg: TransformerConfig, layer: Block, x: torch.Tensor,
           return_kv: bool = False):
    h = layer.norm_attn(x)
    a = gqa_train(layer.attn, _attn_cfg(cfg), h, block=cfg.attn_block,
                  return_kv=return_kv)
    if return_kv:
        a, kv = a
    x = x + a
    y = x + layer.ffn(layer.norm_ffn(x))
    return (y, kv) if return_kv else y


def embed_tokens(model: Transformer, cfg: TransformerConfig,
                 tokens: torch.Tensor, buffers: dict | None = None):
    """tokens [...] -> [..., d]: the full table's rows, or the embedding
    table's lookup (on the card, the fused kernel: one launch a call)."""
    if cfg.embedding is None:
        return model.embed["table_0"][tokens.long()]
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
    """tokens [B, S] -> (hidden [B, S, d], aux)."""
    x = embed_tokens(model, cfg, tokens, buffers).to(cfg.torch_dtype)
    for group in model.groups():
        for layer in group:
            x = _block(cfg, layer, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return model.final_norm(x), aux


def logits_fn(model: Transformer, cfg: TransformerConfig,
              hidden: torch.Tensor, buffers: dict | None = None):
    table = _output_table(model, cfg, buffers)
    return hidden @ table.to(hidden.dtype).T


def loss_fn(model: Transformer, cfg: TransformerConfig, tokens: torch.Tensor,
            labels: torch.Tensor, buffers: dict | None = None):
    """Causal LM cross-entropy in float32; ``cfg.loss_chunk`` > 0 (and
    below S) takes it a sequence chunk at a time, so the [B, S, V] logits
    are never whole.  -> (loss, {"ce", "aux"})."""
    hidden, aux = forward(model, cfg, tokens, buffers)
    table = _output_table(model, cfg, buffers).to(torch.float32)

    def xent(h, y):
        lg = h.to(torch.float32) @ table.T
        lse = torch.logsumexp(lg, dim=-1)
        gold = torch.gather(lg, -1, y.long()[..., None])[..., 0]
        return lse - gold

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

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None) -> dict:
    """Zeroed stacked KV caches: ``layers_{gi}`` -> ``k``, ``v`` [count,
    batch, max_len, KV, hd] (int8 with float32 ``k_scale``, ``v_scale``
    [count, batch, max_len, KV]; else the model's dtype)."""
    dev = resolve_device(device)
    dt = torch.int8 if cfg.kv_quantized else cfg.torch_dtype
    cache = {}
    for gi, (_kind, count) in enumerate(cfg.layer_groups()):
        shape = (count, batch, max_len, cfg.n_kv_heads, cfg.hd)
        g = {"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
        if cfg.kv_quantized:
            g["k_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
            g["v_scale"] = torch.zeros(shape[:-1], dtype=torch.float32,
                                       device=dev)
        cache[f"layers_{gi}"] = g
    return cache


def cache_bytes_per_token(cfg: TransformerConfig) -> int:
    """Cache bytes one token of one sequence holds, over all layers."""
    kv = cfg.n_kv_heads
    per = 2 * kv * cfg.hd * (1 if cfg.kv_quantized
                             else torch.finfo(cfg.torch_dtype).bits // 8)
    if cfg.kv_quantized:
        per += 2 * kv * 4
    return cfg.n_layers * per


@torch.no_grad()
def prefill(model: Transformer, cfg: TransformerConfig, tokens: torch.Tensor,
            buffers: dict | None = None, cache: dict | None = None):
    """tokens [B, S] -> (last-position logits [B, V], KV cache).

    Each layer's (rope'd) keys and values (quantized for an int8 cache) are
    written into rows [0, S) of ``cache``, in place; without one, a cache
    of length S is made (the reference's).  A longer cache lets a server
    decode on from the prefill without a copy: rows past S stay as given
    (zeros from ``init_cache``)."""
    B, S = tokens.shape
    x = embed_tokens(model, cfg, tokens, buffers).to(cfg.torch_dtype)
    if cache is None:
        cache = init_cache(cfg, B, S, x.device)
    for gi, group in enumerate(model.groups()):
        c = cache[f"layers_{gi}"]
        if c["k"].shape[2] < S or c["k"].shape[1] != B:
            raise ValueError(f"a cache of {tuple(c['k'].shape[1:3])} cannot "
                             f"take a prefill of {(B, S)}")
        for li, layer in enumerate(group):
            x, kv = _block(cfg, layer, x, return_kv=True)
            if cfg.kv_quantized:
                for name in ("k", "v"):
                    q, s = quantize_kv(kv[name])
                    c[name][li, :, :S] = q
                    c[f"{name}_scale"][li, :, :S] = s
            else:
                for name in ("k", "v"):
                    c[name][li, :, :S] = kv[name].to(c[name].dtype)
    x = model.final_norm(x)
    return logits_fn(model, cfg, x[:, -1, :], buffers), cache


@torch.no_grad()
def decode_step(model: Transformer, cfg: TransformerConfig,
                tokens: torch.Tensor, cache: dict, cache_len: int,
                buffers: dict | None = None):
    """One decode step: tokens [B] -> (logits [B, V], cache).  The new
    token is written at ``cache_len`` (the current valid length) in place;
    the returned cache is the one given."""
    x = embed_tokens(model, cfg, tokens[:, None], buffers).to(cfg.torch_dtype)
    acfg = _attn_cfg(cfg)
    for gi, group in enumerate(model.groups()):
        c_full = cache[f"layers_{gi}"]
        for li, layer in enumerate(group):
            c_layer = {k: t[li] for k, t in c_full.items()}
            a, _ = gqa_decode(layer.attn, acfg, layer.norm_attn(x), c_layer,
                              cache_len, block=cfg.attn_block)
            x = x + a
            x = x + layer.ffn(layer.norm_ffn(x))
    x = model.final_norm(x)
    return logits_fn(model, cfg, x[:, 0, :], buffers), cache


def param_count(cfg: TransformerConfig) -> tuple[int, int]:
    """(total, active) parameter counts of the dense path."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.hd
    attn = (d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd
            + cfg.n_heads * hd * d)
    emb = cfg.vocab_size * d * (1 if cfg.tied_embeddings else 2)
    total = emb + sum(count * (attn + 3 * d * f)
                      for _kind, count in cfg.layer_groups())
    return int(total), int(total)
