"""Attention: RoPE, int8 KV quantization, the blocked online softmax and
GQA (grouped KV heads); port of ``repro.nn.attention``.

``blocked_attention`` is the reference's flash dataflow written with
``torch.matmul`` on blocks: a Python loop over query chunks, an online
softmax over KV blocks inside, live memory one (q_block x kv_block) score
tile per (batch, head).  The reference computes it outside any Pallas
kernel, so it has no TPU kernel to port; it runs as plain PyTorch on the
card as on the CPU.

The reference's score and value products take bf16 operands with
``preferred_element_type=float32``: exact products summed in float32.
``torch.matmul`` on bf16 operands returns bf16, so both operands are cast
up to float32 first (a product of two bf16 values is exact in float32).

Decode writes the new token's K/V into the caller's cache in place (the
reference's ``dynamic_update_slice`` on a loop carry, which XLA does in
place): the cache dict's tensors are views of the model's stacked cache.

MLA (multi-head latent attention, DeepSeek-V3) trains and prefills through
the naive expansion of its latents into per-head keys and values, and
decodes by the absorbed products against the fused latent cache ``ckv``
[B, L, r + rope_dim]: one KV head of width r + rope_dim, the query heads
grouped over it.

A write position at or past the cache's end clamps to its last row (the
reference's ``dynamic_update_slice``); the query attends every row below
``cache_len + 1``.

Under an installed ``Mesh`` whose 'model' axis divides the cache length,
decode takes ``repro_torch.dist.flash_decode``: the cache given is this
rank's slab of a cache of ``length`` rows, the query and output the whole
batch's (the reference's mesh branch).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.dist import tensor_parallel as tp
from repro_torch.nn.modules import RMSNorm, dense

_NEG_INF = -1e30
_PAD_POS = 2 ** 30                 # position of a padded KV entry


def rope_table(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """positions [...] -> (cos, sin) each [..., dim/2], float32."""
    freqs = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                          device=positions.device) / dim))
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x [..., S, H, hd]; cos/sin [..., S, hd/2], broadcast over heads and
    cast to x's dtype before the multiply (as the reference)."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def quantize_kv(x: torch.Tensor, eps: float = 1e-8):
    """Per-token-per-head absmax int8: x [..., hd] -> (q int8 [..., hd],
    scale float32 [...])."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(torch.amax(torch.abs(xf), dim=-1), eps) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """``(float32(q) * scale).astype(dtype)``; the product is taken in place
    in the float32 copy (the same bits, one [.., hd] float32 buffer less)."""
    x = q.to(torch.float32)
    x.mul_(scale[..., None])
    return x.to(dtype)


def _pad_block(x: torch.Tensor, n: int) -> torch.Tensor:
    """x [B, t, ...] zero-padded to [B, n, ...] along axis 1."""
    if x.shape[1] == n:
        return x
    pad = [0, 0] * (x.dim() - 2) + [0, n - x.shape[1]]
    return F.pad(x, pad)


def _attn_q_chunk(qr: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
                  kv_valid_len, kv_block: int) -> torch.Tensor:
    """Online softmax over KV blocks for one query chunk.

    qr [B, qb, KV, G, hd] (scaled, in q's dtype), k [B, Tc, KV, hd], v [B,
    Tc, KV, vd], q_pos [qb], kv_pos [Tc] -> [B, qb, KV, G, vd] in qr's
    dtype.  The last block is zero-padded with position 2^30, as the
    reference pads the whole KV (only that block has padding)."""
    B, qb, KV, G, hd = qr.shape
    Tc, vd = k.shape[1], v.shape[-1]
    dev = qr.device
    # [B, KV, G*qb, hd] float32: the score product's left operand
    q32 = qr.to(torch.float32).permute(0, 2, 3, 1, 4).reshape(B, KV, G * qb,
                                                               hd)
    m = torch.full((B, KV, G, qb), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G, qb), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, G, qb, vd), dtype=torch.float32, device=dev)
    vl = None
    if kv_valid_len is not None:
        vl = torch.as_tensor(kv_valid_len, dtype=torch.int32,
                             device=dev).reshape(-1).expand(B)
    for lo in range(0, Tc, kv_block):
        hi = min(lo + kv_block, Tc)
        kj = _pad_block(k[:, lo:hi], kv_block)
        vj = _pad_block(v[:, lo:hi], kv_block)
        pj = kv_pos[lo:hi]
        if hi - lo < kv_block:
            pj = F.pad(pj, (0, kv_block - (hi - lo)), value=_PAD_POS)
        s = torch.matmul(q32, kj.to(torch.float32).permute(0, 2, 3, 1))
        # in place on fresh tiles only, which autograd keeps no copy of (the
        # product's backward reads its operands; exp_'s its own result):
        # each score tile is a few hundred MB at prefill_32k
        s = s.view(B, KV, G, qb, kv_block)
        if causal:
            s.masked_fill_(~(pj[None, :] <= q_pos[:, None]), _NEG_INF)
        if vl is not None:
            s.masked_fill_(
                ~(pj[None, :] < vl[:, None])[:, None, None, None, :],
                _NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        corr = torch.exp(m - m_new)
        p = (s - m_new[..., None]).exp_()
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.matmul(p.to(vj.dtype).to(torch.float32).view(
            B, KV, G * qb, kv_block),
            vj.to(torch.float32).permute(0, 2, 1, 3))
        acc = acc * corr[..., None] + pv.view(B, KV, G, qb, vd)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    # cast per chunk, as the reference: the float32 sums already happened
    return out.permute(0, 3, 1, 2, 4).to(qr.dtype)        # [B, qb, KV, G, vd]


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_positions: torch.Tensor,
                      kv_positions: torch.Tensor, kv_valid_len=None,
                      block: int = 1024, q_block: int = 512,
                      sm_scale: float | None = None,
                      aligned: bool | None = None) -> torch.Tensor:
    """q [B, S, H, hd], k [B, T, KV, hd], v [B, T, KV, vd] -> [B, S, H, vd]
    in q's dtype.  ``kv_valid_len`` (None, an int, or [B]): KV entries at
    positions < it are valid.  Causal and aligned (query i at position i
    of the same prefix) chunks skip the KV blocks wholly in their future, a
    static triangle at ``block`` granularity, as the reference."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = sm_scale if sm_scale is not None else 1.0 / np.sqrt(hd)
    if aligned is None:
        aligned = causal
    qr = (q * scale).to(q.dtype).reshape(B, S, KV, G, hd)
    qb = min(q_block, S)
    outs = []
    for lo in range(0, S, qb):
        hi = min(lo + qb, S)
        t_need = min(T, -(-hi // block) * block) if causal and aligned \
            else T
        outs.append(_attn_q_chunk(qr[:, lo:hi], k[:, :t_need],
                                  v[:, :t_need], q_positions[lo:hi],
                                  kv_positions[:t_need], causal,
                                  kv_valid_len, block))
    out = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


# ------------------------------------------------------------ GQA attention

@dataclasses.dataclass(frozen=True)
class GQAConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int | None = None
    qkv_bias: bool = False       # Qwen1.5 uses QKV bias
    rope_theta: float = 10000.0

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.d_model // self.n_heads


class GQA(nn.Module):
    """The projections ``wq``, ``wk``, ``wv`` (bias if ``qkv_bias``) and
    ``wo`` (no bias), named as the reference's leaves."""

    def __init__(self, cfg: GQAConfig, generator: torch.Generator, device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hd, d = cfg.hd, cfg.d_model
        self.wq = dense(d, cfg.n_heads * hd, generator, device, cfg.qkv_bias,
                        dtype=dtype)
        self.wk = dense(d, cfg.n_kv_heads * hd, generator, device,
                        cfg.qkv_bias, dtype=dtype)
        self.wv = dense(d, cfg.n_kv_heads * hd, generator, device,
                        cfg.qkv_bias, dtype=dtype)
        self.wo = dense(cfg.n_heads * hd, d, generator, device, False,
                        dtype=dtype)


def gqa_init(cfg: GQAConfig, generator: torch.Generator, device,
             dtype: torch.dtype = torch.float32) -> GQA:
    return GQA(cfg, generator, device, dtype)


def gqa_qkv(p: GQA, cfg: GQAConfig, x: torch.Tensor,
            positions: torch.Tensor, lay: tp.Layout = tp.PLAIN):
    """x [B, S, d] -> roped q [B, S, h, hd], roped k and v [B, S, kvh,
    hd]: every head, or under a split training layout (``lay``) this
    rank's query heads and the KV heads they read (``wk`` / ``wv``
    column-parallel too where 'model' divides the KV heads, so the groups
    stay aligned; else gathered whole and cut to the one KV head this
    rank's query heads share, their gradient reduce-scattered back)."""
    B, S, _ = x.shape
    hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    h0, nh = lay.heads(H)
    x = lay.enter(x)
    q = lay.lin(x, p.wq).reshape(B, S, nh, hd)
    kvh, rows = nh * KV // H, None
    if lay.split and not (KV % lay.mesh.model == 0
                          and tp.model_dim(p.wk.weight) == 0):
        G = H // KV
        if G % nh:
            raise NotImplementedError(
                f"{nh} query heads a rank straddle the groups of {G}")
        kv0 = h0 // G
        kvh, rows = 1, slice(kv0 * hd, (kv0 + 1) * hd)
    k = lay.lin(x, p.wk, rows).reshape(B, S, kvh, hd)
    v = lay.lin(x, p.wv, rows).reshape(B, S, kvh, hd)
    cos, sin = rope_table(positions, hd, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def gqa_train(p: GQA, cfg: GQAConfig, x: torch.Tensor, block: int = 512,
              return_kv: bool = False):
    """Causal self-attention over a full sequence (training / prefill).
    Stored for training under a mesh (``tp.layout``), the query heads
    split over 'model', ``wo`` row-parallel and summed over 'model'; x is
    the rank's share, replicated over 'model'."""
    lay = tp.layout(p.wq.weight)
    _no_kv(lay, return_kv)
    B, S, _ = x.shape
    pos = torch.arange(S, dtype=torch.int32, device=x.device)
    q, k, v = gqa_qkv(p, cfg, x, pos, lay)
    o = blocked_attention(q, k, v, causal=True, q_positions=pos,
                          kv_positions=pos, block=block)
    out = lay.out(o.reshape(B, S, -1), p.wo)
    if return_kv:
        return out, {"k": k, "v": v}
    return out


def _no_kv(lay: tp.Layout, return_kv: bool) -> None:
    if return_kv and lay is not tp.PLAIN:
        raise NotImplementedError(
            "a model stored for training under a mesh does not prefill: "
            "serve from one built to serve (init(..., mesh=))")


def _mesh_for(L: int):
    """The installed mesh when decode shards a cache of L rows (its
    'model' axis divides L, the reference's rule), else None."""
    from repro_torch.dist.context import current_mesh
    mesh = current_mesh()
    return mesh if mesh is not None and L % mesh.model == 0 else None


def gqa_decode(p: GQA, cfg: GQAConfig, x: torch.Tensor, cache: dict,
               cache_len: int, block: int = 1024, length: int | None = None):
    """One-token decode.  x [B, 1, d]; cache {"k", "v"} [B, L, KV, hd]
    (int8 with "k_scale" / "v_scale" [B, L, KV]).  The new token's K/V are
    written at ``cache_len`` (clamped to L - 1) in place; returns (out [B,
    1, d], cache).  Under a mesh the cache is this rank's slab of a cache
    of ``length`` rows (default: the slab's own)."""
    from repro_torch.dist.context import dp_axes
    from repro_torch.dist.flash_decode import sharded_flash_decode
    B = x.shape[0]
    L = int(length) if length is not None else cache["k"].shape[1]
    cache_len = int(cache_len)
    pos = torch.full((1,), cache_len, dtype=torch.int32, device=x.device)
    q, k_new, v_new = gqa_qkv(p, cfg, x, pos)
    quant = cache["k"].dtype == torch.int8
    mesh = _mesh_for(L)
    if mesh is not None:
        kw = {}
        if quant:
            (k_new, kw["k_scale_new"]), (v_new, kw["v_scale_new"]) = (
                quantize_kv(k_new), quantize_kv(v_new))
            kw.update(k_scale=cache["k_scale"], v_scale=cache["v_scale"])
        o = sharded_flash_decode(
            q, cache["k"], cache["v"], k_new, v_new, cache_len,
            sm_scale=1.0 / np.sqrt(cfg.hd), mesh=mesh, dp_axes=dp_axes(mesh),
            length=L, block=block, **kw)
        return p.wo(o.reshape(B, 1, cfg.n_heads * cfg.hd)), cache
    at = slice(min(cache_len, L - 1), min(cache_len, L - 1) + 1)
    if quant:
        for name, new in (("k", k_new), ("v", v_new)):
            qn, sn = quantize_kv(new)
            cache[name][:, at] = qn
            cache[f"{name}_scale"][:, at] = sn
        kf = dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        vf = dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        cache["k"][:, at] = k_new.to(cache["k"].dtype)
        cache["v"][:, at] = v_new.to(cache["v"].dtype)
        kf, vf = cache["k"], cache["v"]
    kv_pos = torch.arange(L, dtype=torch.int32, device=x.device)
    o = blocked_attention(q, kf, vf, causal=False, q_positions=pos,
                          kv_positions=kv_pos, kv_valid_len=cache_len + 1,
                          block=block)
    return p.wo(o.reshape(B, 1, cfg.n_heads * cfg.hd)), cache


# ------------------------------------------------------------ MLA attention

@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora_rank: int = 1536      # 0 -> direct q projection
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim


class MLA(nn.Module):
    """``wq_a``, ``q_norm``, ``wq_b`` (or ``wq`` when ``q_lora_rank`` is
    0), ``wkv_a``, ``kv_norm``, ``wkv_b`` and ``wo``, bias-free, named as
    the reference's leaves."""

    def __init__(self, cfg: MLAConfig, generator: torch.Generator, device,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        H, d = cfg.n_heads, cfg.d_model
        if cfg.q_lora_rank > 0:
            self.wq_a = dense(d, cfg.q_lora_rank, generator, device, False,
                              dtype=dtype)
            self.q_norm = RMSNorm(cfg.q_lora_rank, device, dtype)
            self.wq_b = dense(cfg.q_lora_rank, H * cfg.qk_dim, generator,
                              device, False, dtype=dtype)
        else:
            self.wq = dense(d, H * cfg.qk_dim, generator, device, False,
                            dtype=dtype)
        self.wkv_a = dense(d, cfg.kv_lora_rank + cfg.qk_rope_dim, generator,
                           device, False, dtype=dtype)
        self.kv_norm = RMSNorm(cfg.kv_lora_rank, device, dtype)
        self.wkv_b = dense(cfg.kv_lora_rank,
                           H * (cfg.qk_nope_dim + cfg.v_head_dim), generator,
                           device, False, dtype=dtype)
        self.wo = dense(H * cfg.v_head_dim, d, generator, device, False,
                        dtype=dtype)


def mla_init(cfg: MLAConfig, generator: torch.Generator, device,
             dtype: torch.dtype = torch.float32) -> MLA:
    return MLA(cfg, generator, device, dtype)


def _mla_q(p: MLA, cfg: MLAConfig, x: torch.Tensor,
           positions: torch.Tensor, lay: tp.Layout = tp.PLAIN):
    """x [B, S, d] -> (q_nope [B, S, h, nope], q_rope [B, S, h, rd]):
    every head, or this rank's under a split training layout (``wq_a``
    whole, ``wq_b`` or a direct ``wq`` column-parallel)."""
    B, S, _ = x.shape
    _, nh = lay.heads(cfg.n_heads)
    if cfg.q_lora_rank > 0:
        q = lay.lin(lay.enter(p.q_norm(lay.lin(x, p.wq_a))), p.wq_b)
    else:
        q = lay.lin(lay.enter(x), p.wq)
    q = q.reshape(B, S, nh, cfg.qk_dim)
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim], -1)
    cos, sin = rope_table(positions, cfg.qk_rope_dim, cfg.rope_theta)
    return q_nope, apply_rope(q_rope, cos, sin)


def _mla_ckv(p: MLA, cfg: MLAConfig, x: torch.Tensor,
             positions: torch.Tensor, lay: tp.Layout = tp.PLAIN):
    """x [B, S, d] -> (c_kv [B, S, r] normed, k_rope [B, S, rd]: the one
    rope key all heads share), ``wkv_a`` whole."""
    c_kv, k_rope = torch.split(lay.lin(x, p.wkv_a),
                               [cfg.kv_lora_rank, cfg.qk_rope_dim], -1)
    c_kv = p.kv_norm(c_kv)
    cos, sin = rope_table(positions, cfg.qk_rope_dim, cfg.rope_theta)
    return c_kv, apply_rope(k_rope[..., None, :], cos, sin)[..., 0, :]


def mla_train(p: MLA, cfg: MLAConfig, x: torch.Tensor, block: int = 512,
              return_kv: bool = False):
    """Causal MLA over a full sequence (training / prefill), the latents
    expanded into per-head keys and values; ``return_kv`` also gives the
    fused latent ``{"ckv": cat(c_kv, k_rope)}`` [B, S, r + rd].  Stored
    for training under a mesh (``tp.layout``): the down projections
    ``wq_a`` / ``wkv_a`` gathered over the dp axes and run whole (their
    latents and norms replicated over 'model'), the up projections
    column-parallel by heads, ``wo`` row-parallel and summed over
    'model'."""
    lay = tp.layout(p.wkv_b.weight)
    _no_kv(lay, return_kv)
    B, S, _ = x.shape
    _, nh = lay.heads(cfg.n_heads)
    pos = torch.arange(S, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, pos, lay)
    c_kv, k_rope = lay.enter(*_mla_ckv(p, cfg, x, pos, lay))
    kv = lay.lin(c_kv, p.wkv_b).reshape(B, S, nh,
                                        cfg.qk_nope_dim + cfg.v_head_dim)
    k_nope, v = torch.split(kv, [cfg.qk_nope_dim, cfg.v_head_dim], -1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, nh, cfg.qk_rope_dim)], dim=-1)
    o = blocked_attention(q, k, v, causal=True, q_positions=pos,
                          kv_positions=pos, block=block,
                          sm_scale=1.0 / np.sqrt(cfg.qk_dim))
    out = lay.out(o.reshape(B, S, -1), p.wo)
    if return_kv:
        return out, {"ckv": torch.cat([c_kv, k_rope], dim=-1)}
    return out


def mla_decode(p: MLA, cfg: MLAConfig, x: torch.Tensor, cache: dict,
               cache_len: int, block: int = 2048, length: int | None = None):
    """Absorbed-matmul decode against the fused latent cache.  x [B, 1, d];
    cache {"ckv": [B, L, r + rd]} (int8 with "ckv_scale" [B, L]: one scale
    a token over the fused width).  The new token's latent is written at
    ``cache_len`` (clamped to L - 1) in place; attention runs in latent
    space, ``(q_nope W_uk | q_rope) . (c_kv | k_rope)``, one KV head of
    width r + rd that all H query heads share, values the latents' first r
    columns, then ``W_uv`` and ``wo``.  Under a mesh the cache is this
    rank's slab of a cache of ``length`` rows, the latent passed as K and
    its first r columns as V, with one scale for both (the reference's).
    -> (out [B, 1, d], cache)."""
    from repro_torch.dist.context import dp_axes
    from repro_torch.dist.flash_decode import sharded_flash_decode
    B = x.shape[0]
    H, r = cfg.n_heads, cfg.kv_lora_rank
    nope, vd = cfg.qk_nope_dim, cfg.v_head_dim
    L = int(length) if length is not None else cache["ckv"].shape[1]
    cache_len = int(cache_len)
    pos = torch.full((1,), cache_len, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, cfg, x, pos)                  # [B, 1, H, *]
    c_new, kr_new = _mla_ckv(p, cfg, x, pos)
    # wkv_b.weight is the reference's kernel [r, H * (nope + vd)] transposed
    w = p.wkv_b.weight.view(H, nope + vd, r)
    w_uk, w_uv = w[:, :nope], w[:, nope:]                   # [H, *, r]
    q_c = torch.einsum("bshn,hnr->bshr", q_nope, w_uk)
    q_cat = torch.cat([q_c, q_rope], dim=-1)                 # [B, 1, H, r+rd]
    kn_cat = torch.cat([c_new, kr_new], dim=-1)              # [B, 1, r+rd]
    quant = cache["ckv"].dtype == torch.int8
    scale = 1.0 / np.sqrt(cfg.qk_dim)
    mesh = _mesh_for(L)
    if mesh is not None:
        k_cat = cache["ckv"][:, :, None, :]                  # [B, L, 1, r+rd]
        kn = kn_cat[:, :, None, :]
        kw = {}
        if quant:
            kn, kn_s = quantize_kv(kn)
            sc = cache["ckv_scale"][:, :, None]
            kw = dict(k_scale=sc, v_scale=sc, k_scale_new=kn_s,
                      v_scale_new=kn_s)
        o_lat = sharded_flash_decode(
            q_cat, k_cat, k_cat[..., :r], kn, kn[..., :r], cache_len,
            sm_scale=scale, mesh=mesh, dp_axes=dp_axes(mesh), length=L,
            block=block, **kw)
    else:
        w_at = min(cache_len, L - 1)
        at = slice(w_at, w_at + 1)
        if quant:
            kn_q, kn_s = quantize_kv(kn_cat)
            cache["ckv"][:, at] = kn_q
            cache["ckv_scale"][:, at] = kn_s
            ck_f = dequantize_kv(cache["ckv"], cache["ckv_scale"], x.dtype)
        else:
            cache["ckv"][:, at] = kn_cat.to(cache["ckv"].dtype)
            ck_f = cache["ckv"]
        kv_pos = torch.arange(L, dtype=torch.int32, device=x.device)
        o_lat = blocked_attention(q_cat, ck_f[:, :, None, :],
                                  ck_f[:, :, None, :r], causal=False,
                                  q_positions=pos, kv_positions=kv_pos,
                                  kv_valid_len=cache_len + 1, block=block,
                                  sm_scale=scale)
    o = torch.einsum("bshr,hvr->bshv", o_lat, w_uv)
    return p.wo(o.reshape(B, 1, H * vd)), cache
