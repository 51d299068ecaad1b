"""Flash-decoding with the KV-cache *length* sharded over the mesh (port of
``repro.dist.flash_decode``).

Decode attends one query against an L-long cache.  The cache length
shards over 'model' plus every dp axis the batch leaves idle
(``sharding.LM_CACHE_RULES``), so a B = 1 long-context cache spans the
whole mesh.  Each rank holds its slab ``[B_l, L / n, ...]`` of the cache
(``plan`` says which) and the whole batch's query; it

  1. writes the new entry in place iff the write position falls inside its
     slab (the position clamps to L - 1, as the one-card write: a full
     cache overwrites its last slot, on the last rank);
  2. computes online-softmax partials (running max m, normalizer l, value
     accumulator) over its slab, a KV block at a time, each int8 block
     dequantized to float32 as it is read (the slab is never whole in
     float32; a block is ``block`` positions, or as many as
     ``BLOCK_BYTES`` of float32 K and V hold);
  3. merges across slabs by log-sum-exp: one ``all_gather`` of every
     slab's (m, l, acc), then on every rank ``m* = max(m)`` and the sums
     of ``l * exp(m - m*)`` and ``acc * exp(m - m*)`` (the reference's
     ``pmax`` and ``psum``, in one collective);
  4. gathers the batch shares over the batch axes, so every rank returns
     the whole batch's output.

The reference's body forms its whole slab in float32 and sums it in one
softmax; the port's block loop is the same sums in another order.  Scores
and values are float32 throughout (the reference's
``preferred_element_type``), the query scaled in float32.  ``_unsharded``
is the fallback where the mesh cannot shard L: the one-card decode on a
whole cache.
"""
from __future__ import annotations

import torch

from repro_torch.dist import collectives as col
from repro_torch.dist.sharding import axes_size, block_bounds

_NEG_INF = -1e30
# a KV block's float32 K and V on a rank at most this many bytes: few rows
# take long blocks (a B = 1 slab of 131,072 positions in one), so the
# Python loop over blocks stays short
BLOCK_BYTES = 256 * 2 ** 20


def plan(mesh, dp_axes, B: int, L: int):
    """-> (batch_axes, seq_axes), or None when L cannot shard.

    The batch takes the dp axes when it divides them; the cache length
    takes 'model' plus whatever dp axes the batch left idle (mesh order),
    falling back to 'model' alone."""
    if mesh is None:
        return None
    dp = tuple(a for a in dp_axes if a in mesh.axis_names)
    batch = dp if (axes_size(mesh, dp) > 1
                   and B % axes_size(mesh, dp) == 0) else ()
    seq_full = tuple(a for a in mesh.axis_names
                     if a == "model" or (a in dp and a not in batch))
    for seq in (seq_full, ("model",)):
        n = axes_size(mesh, seq)
        if n > 1 and L % n == 0:
            return batch, seq
    return None


def _write(slab: torch.Tensor, new: torch.Tensor, rel: int) -> None:
    slab[:, rel:rel + 1] = new.to(slab.dtype)


def sharded_flash_decode(q, k_cache, v_cache, k_new, v_new, cache_len: int,
                         *, sm_scale: float, mesh, dp_axes, length: int,
                         k_scale=None, v_scale=None, k_scale_new=None,
                         v_scale_new=None, block: int = 1024):
    """LSE-merged decode attention + in-place update of this rank's slab.

    q [B, 1, H, hd] and the new entries k_new [B, 1, KV, hd], v_new [B, 1,
    KV, vd] (int8 with ``k_scale_new`` / ``v_scale_new`` [B, 1, KV]) are
    the whole batch's; ``k_cache`` / ``v_cache`` [B_l, L_l, KV, *] (and the
    scales [B_l, L_l, KV]) are this rank's slab of a cache of ``length``
    rows, as ``plan`` cuts it (the whole cache when it returns None).
    ``v_cache`` may be a view of ``k_cache`` (MLA's latent): it is then
    read from the dequantized K block.  -> o [B, 1, H, vd] in q's dtype,
    the same on every rank; the slabs are written in place."""
    B, _, H, hd = q.shape
    L = int(length)
    pl = plan(mesh, dp_axes, B, L)
    if pl is None:
        return _unsharded(q, k_cache, v_cache, k_new, v_new, cache_len,
                          sm_scale, k_scale, v_scale, k_scale_new,
                          v_scale_new, block)
    batch, seq = pl
    KV, vd = k_cache.shape[2], v_cache.shape[-1]
    G = H // KV
    b0, b1 = block_bounds(mesh, batch, B)
    lo, hi = block_bounds(mesh, seq, L)
    l_loc = hi - lo
    if tuple(k_cache.shape[:2]) != (b1 - b0, l_loc):
        raise ValueError(f"a slab of {tuple(k_cache.shape[:2])} is not this "
                         f"rank's [{b0}:{b1}, {lo}:{hi}] of ({B}, {L})")
    quant = k_cache.dtype == torch.int8
    shared_v = v_cache.data_ptr() == k_cache.data_ptr()
    pos = int(cache_len)
    wpos = min(max(pos, 0), L - 1)
    if lo <= wpos < hi:
        rel = wpos - lo
        _write(k_cache, k_new[b0:b1], rel)
        _write(v_cache, v_new[b0:b1], rel)
        if quant:
            _write(k_scale, k_scale_new[b0:b1].to(torch.float32), rel)
            _write(v_scale, v_scale_new[b0:b1].to(torch.float32), rel)

    Bl = b1 - b0
    dev = q.device
    q32 = (q[b0:b1].to(torch.float32) * sm_scale).reshape(Bl, KV, G, hd)
    m = torch.full((Bl, KV, G), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((Bl, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((Bl, KV, G, vd), dtype=torch.float32, device=dev)
    blk = max(block, BLOCK_BYTES // (4 * Bl * KV * (hd + vd)))
    # blocks wholly past the last valid position add exactly nothing
    end = min(hi, pos + 1) - lo
    for a in range(0, max(end, 0), blk):
        e = min(a + blk, l_loc)
        kf = k_cache[:, a:e].to(torch.float32)
        if quant:
            kf.mul_(k_scale[:, a:e, :, None])
        if shared_v:
            vf = kf[..., :vd]
        else:
            vf = v_cache[:, a:e].to(torch.float32)
            if quant:
                vf.mul_(v_scale[:, a:e, :, None])
        s = torch.matmul(q32, kf.permute(0, 2, 3, 1))        # [Bl,KV,G,t]
        kv_pos = torch.arange(lo + a, lo + e, device=dev)
        s.masked_fill_(~(kv_pos < pos + 1), _NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        corr = torch.exp(m - m_new)
        p = (s - m_new[..., None]).exp_()
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.matmul(p, vf.permute(0, 2, 1, 3))
        m = m_new
    # every slab's (m, l, acc) in one gather, merged here: one collective
    # where pmax then psum take two, the same bits on every rank
    parts = col.all_gather(torch.cat([m[..., None], l[..., None], acc],
                                     dim=-1), mesh, seq)
    m_all = parts[..., 0]
    corr = torch.exp(m_all - m_all.amax(dim=0))      # 0 for an empty slab
    merged = (parts[..., 1:] * corr[..., None]).sum(dim=0)
    o = merged[..., 1:] / torch.clamp_min(merged[..., :1], 1e-30)
    o = o.reshape(Bl, 1, H, vd).to(q.dtype)
    if batch:
        o = col.all_gather(o, mesh, batch).reshape(B, 1, H, vd)
    return o


def _unsharded(q, k_cache, v_cache, k_new, v_new, cache_len, sm_scale,
               k_scale, v_scale, k_scale_new, v_scale_new, block):
    """The fallback where the mesh cannot shard L: every rank holds the
    whole cache and runs the one-card decode (write clamped to L - 1,
    dequantization to q's dtype, ``blocked_attention``)."""
    from repro_torch.nn.attention import blocked_attention, dequantize_kv

    L = k_cache.shape[1]
    pos = int(cache_len)
    at = min(max(pos, 0), L - 1)
    _write(k_cache, k_new, at)
    _write(v_cache, v_new, at)
    if k_cache.dtype == torch.int8:
        _write(k_scale, k_scale_new.to(torch.float32), at)
        _write(v_scale, v_scale_new.to(torch.float32), at)
        kf = dequantize_kv(k_cache, k_scale, q.dtype)
        vf = dequantize_kv(v_cache, v_scale, q.dtype)
    else:
        kf, vf = k_cache, v_cache
    dev = q.device
    return blocked_attention(
        q, kf, vf, causal=False,
        q_positions=torch.full((1,), pos, dtype=torch.int32, device=dev),
        kv_positions=torch.arange(L, dtype=torch.int32, device=dev),
        kv_valid_len=pos + 1, sm_scale=sm_scale, block=block)


def cache_split(mesh, dp_axes, B: int, L: int) -> tuple:
    """((b0, b1), (lo, hi)): this rank's batch rows and cache positions of
    a [B, L] cache (the whole cache where ``plan`` returns None)."""
    pl = plan(mesh, dp_axes, B, L)
    if pl is None:
        return (0, B), (0, L)
    batch, seq = pl
    return block_bounds(mesh, batch, B), block_bounds(mesh, seq, L)
