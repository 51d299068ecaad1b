"""Plain-PyTorch emulations of CUDA kernels' schedules, for the tests.

Nothing in ``repro_torch`` imports this module, and it imports no JAX, so
the CPU tests and the card-only tests (``test_torch_kernels_cuda.py``) both
use it:

- ``dot_interaction_schedule``: ``csrc/dot_interaction.cu``'s groups of G
  samples walked by a persistent grid, its register tiles
  (``kernel.dot_tiles``) and the contiguous output span of each group, each
  written place counted;
- ``tile_walk``: ``csrc/fused_embed.cu``'s (row, column tile) walk
  (``tile_walk`` and ``value_columns``), shared by the flat and bag lookup,
  the locations and the chunk lookup: which (row, column) each lane of each
  warp of the grid emits, counted;
- ``scatter_schedule``: ``fused_scatter_kernel``'s persistent grid: each
  block's bulk copies of the pool's zero fill (its warp 0's), and its
  warps' turns at the block's work queue and the grid's tail in a random
  order, the fill's length random too: which (value, column tile) items
  are staged before the grid barrier and which hashed after, the staging
  rounds each warp uses and the takes that end each warp;
- ``weight_grad_lanes``: ``fused_weight_grad_kernel``'s order of sums (each
  lane's columns c = lane, lane + 32, ..., product then sum, then the
  xor-shuffle tree 16, 8, 4, 2, 1), every operation rounded to float32 alone
  as the kernel rounds it, so on the card it gives the kernel's bits;
- ``row_geometry``, ``row_tree`` and ``row_fold_schedule``: the sparse
  optimizers' row kernels (``csrc/sparse_update.cu``, row layout): how a row
  sits in lanes and units, the row-wise mean's tree over that layout, and
  the bucketed fold's walk (spans of 32 entries, heads from the span, each
  live head's run folded in head-aligned blocks of 8 through a carry stack,
  then ``as_reference``); ``row_update_schedule`` runs an op on the
  walk's sums;
- ``fmaf`` and ``bag_fma_chain``: CUDA's fused multiply-add, rounded once,
  emulated in float64, and the embedding bag's order of sums (each column
  an ``fmaf`` chain in l order, ids outside [0, V) skipped).
"""
from __future__ import annotations

import random

import torch

from repro_torch.kernels.dot_interaction.kernel import TI, TJ
from repro_torch.kernels.fused_embed.kernel import WARPS_PER_BLOCK
from repro_torch.kernels.sparse_update import ref as sref

WARP = 32
SPAN = 32            # csrc/sparse_update.cu: entries a warp takes at a time
FOLD_BLOCK = 8       # entries a fold step loads


def dot_interaction_schedule(x: torch.Tensor, G: int, grid: int,
                             tiles) -> torch.Tensor:
    """x [B, F, d] -> [B, F(F-1)/2] by the kernel's schedule: block ``blk``
    of ``grid`` takes groups blk, blk + grid, ...; each group's samples are
    computed tile by tile into a [G, P] staging row, which is copied to the
    group's span of the output, 4 floats at a time where the spans are
    4-float aligned, then the tail.  Raises unless every pair of a group is
    written once to staging and every output place once."""
    B, F, d = x.shape
    P = F * (F - 1) // 2
    t = torch.as_tensor(tiles, dtype=torch.int64)
    i0, j0, nt = t & 0x3FF, (t >> 10) & 0x3FF, t >> 20
    rows_i = i0[:, None] + torch.arange(TI)                 # [T, TI]
    rows_j = j0[:, None] + torch.arange(TJ) * nt[:, None]   # [T, TJ]
    ii, jj = rows_i[:, :, None], rows_j[:, None, :]
    valid = (ii < F) & (jj < ii)                             # [T, TI, TJ]
    place = (ii * (ii - 1) // 2 + jj).expand(valid.shape)
    ra, rb = rows_i.clamp(max=F - 1), rows_j.clamp(max=F - 1)
    out = torch.full((B * P,), float("nan"), dtype=x.dtype)
    stored = torch.zeros(B * P, dtype=torch.int64)
    n_groups = -(-B // G)
    vec_out = (G * P) % 4 == 0
    for blk in range(min(grid, n_groups)):
        for grp in range(blk, n_groups, grid):
            ns = min(G, B - grp * G)
            zs = torch.full((G * P,), float("nan"), dtype=x.dtype)
            hits = torch.zeros(G * P, dtype=torch.int64)
            for s in range(ns):
                xs = x[grp * G + s]
                A, Bm = xs[ra], xs[rb]          # [T, TI, d], [T, TJ, d]
                acc = torch.zeros((len(t), TI, TJ), dtype=x.dtype)
                for k in range(d):              # the chain's order over k
                    acc = acc + A[:, :, None, k] * Bm[:, None, :, k]
                zs[s * P + place[valid]] = acc[valid]
                hits.index_add_(0, s * P + place[valid],
                                torch.ones_like(place[valid]))
            if not torch.equal(hits[:ns * P], torch.ones(ns * P,
                                                         dtype=torch.int64)):
                raise AssertionError(f"group {grp}: a pair written "
                                     "twice or never")
            o, n = grp * G * P, ns * P
            q0 = n // 4 * 4 if vec_out else 0
            for q in range(0, q0, 4):           # 16-byte stores
                out[o + q:o + q + 4] = zs[q:q + 4]
            out[o + q0:o + n] = zs[q0:n]        # the tail, one float each
            stored[o:o + n] += 1
    if not torch.equal(stored, torch.ones_like(stored)):
        raise AssertionError("an output place written twice or never")
    return out.view(B, P)


def tile_walk(rows: int, d: int, tile: int) -> torch.Tensor:
    """-> [rows, d] int64: how often the walk emits each (row, column).
    The grid is ceil(rows * n_tiles / 8) blocks of 8 warps (n_tiles =
    ceil(d / tile)); warp w of the grid takes the units w, w + stride, ...
    below rows * n_tiles (stride: the grid's warps); unit u is row
    u // n_tiles and the columns [c0, c1) of tile u % n_tiles (c0 = that
    tile times ``tile``, c1 = min(d, c0 + tile)); lane l of the warp emits
    the columns c0 + l, c0 + l + 32, ... below c1."""
    n_tiles = -(-d // tile)
    units = rows * n_tiles
    stride = -(-units // WARPS_PER_BLOCK) * WARPS_PER_BLOCK
    hits = torch.zeros(rows * d, dtype=torch.int64)
    warp = torch.arange(stride)
    lane = torch.arange(WARP)[:, None]
    step = WARP * torch.arange(-(-tile // WARP))[None, :]
    for first in range(0, units, stride):
        u = warp + first
        u = u[u < units]
        row = u // n_tiles
        c0 = (u - row * n_tiles) * tile
        c1 = torch.clamp(c0 + tile, max=d)
        col = c0[:, None, None] + lane + step             # [warps, 32, k]
        live = col < c1[:, None, None]
        flat = (row[:, None, None] * d + col)[live]
        hits.index_add_(0, flat, torch.ones_like(flat))
    return hits.view(rows, d)


STAGE_ROUNDS = 10    # csrc/fused_embed.cu: staged slots a lane (320 a warp)
ZERO_F4 = 256        # float4s of zeros a bulk copy of the fill moves
TAIL_SHARE = 2       # the grid's tail: the last 1/TAIL_SHARE of the items
TAIL_CHUNK_ITEMS = 4  # a warp's items for each chunk it takes


def scatter_schedule(rows: int, L: int, d: int, tile: int, m_local: int,
                     grid: int, seed: int = 0) -> dict:
    """``fused_scatter_kernel`` on ``grid`` blocks of 8 warps, for ``rows``
    output rows of ``L`` values at width ``d``, the [m_local] buffer; the
    warps' turns at their queues, and how long each block's fill runs,
    drawn at random from ``seed`` (the card may take any of them).

    Items: q is value l = q % L of unit u = q // L (row u // n_tiles,
    column tile u % n_tiles); an item of k columns takes ceil(k / 32)
    rounds, lane j emitting c0 + j + 32 r in round r.  Block b owns the
    items [n_own * b // grid, n_own * (b + 1) // grid) of the first
    n_own = n - n // TAIL_SHARE; the rest, the grid's tail, goes to any
    warp.  Warp 0 fills: block b's float4s [n4 * b // grid,
    n4 * (b + 1) // grid) (n4 = m_local // 4) in bulk copies of ZERO_F4,
    the last m_local % 4 floats block 0's.  Before the grid barrier warps
    1-7 take items one at a time from their block's counter while they
    have room for k_max rounds (a whole tile's) and the fill runs, and
    stage each; a take past the block's items ends the warp's staging.
    After it, each warp takes chunks of ``chunk`` items, from its block's
    counter while that has items, then from the tail's, hashes and adds
    them, and at an empty chunk adds its staged items and ends.

    -> ``staged`` bool and ``hits`` int64 [rows * L, n_tiles] (value v =
    row * L + l), ``columns`` int64 [d] (how often the units of a row's
    tiles together emit each column), ``rounds`` int64 [W] (the rounds each
    warp staged), ``n_own``, ``empty`` (the takes that gave an empty chunk)
    and ``fill`` int64 [n, 2], every bulk copy and the tail as a span
    [start, end) of floats."""
    n_tiles = -(-d // tile)
    n_items = rows * n_tiles * L
    W = grid * WARPS_PER_BLOCK
    c0 = torch.arange(n_tiles) * tile
    width = torch.clamp(c0 + tile, max=d) - c0
    k_of = (-(-width // WARP)).tolist()                      # per tile
    lane = torch.arange(WARP)[:, None]
    r = torch.arange(max(k_of))[None, :]
    columns = torch.zeros(d, dtype=torch.int64)
    for t in range(n_tiles):
        col = (c0[t] + lane + WARP * r)[(lane + WARP * r) < width[t]]
        columns.index_add_(0, col, torch.ones_like(col))
    k_max = -(-min(tile, d) // WARP)
    n_own = n_items - n_items // TAIL_SHARE
    chunk = max(1, min(8, n_items // (W * TAIL_CHUNK_ITEMS)))
    hi = [n_own * (b + 1) // grid for b in range(grid)]
    rng = random.Random(seed)
    queue = [n_own * b // grid for b in range(grid)]
    tail = n_own
    # the stage takes each block makes before its fill (and the grid's)
    # has landed: any count up to what its warps 1-7 hold
    filling = [rng.randrange(7 * (STAGE_ROUNDS // k_max) + 2)
               if k_max <= STAGE_ROUNDS else 0 for _ in range(grid)]
    hits = torch.zeros(n_items, dtype=torch.int64)
    staged = torch.zeros(n_items, dtype=torch.bool)
    used = [0] * W
    items = [[] for _ in range(W)]

    active = [w for w in range(W) if w % WARPS_PER_BLOCK]
    while active:            # before the barrier: one take a turn
        i = rng.randrange(len(active))
        w = active[i]
        b = w // WARPS_PER_BLOCK
        q = None
        if used[w] + k_max <= STAGE_ROUNDS and filling[b]:
            q, queue[b] = queue[b], queue[b] + 1
        if q is None or q >= hi[b]:
            active[i] = active[-1]
            active.pop()
            continue
        filling[b] -= 1
        staged[q] = True
        items[w].append(q)
        used[w] += k_of[(q // L) % n_tiles]
    span = [(0, 0)] * W      # after it: [q, end), the chunk in hand
    empty = 0
    active = list(range(W))
    while active:
        i = rng.randrange(len(active))
        w = active[i]
        b = w // WARPS_PER_BLOCK
        q, end = span[w]
        if q >= end:
            q, queue[b] = queue[b], queue[b] + chunk
            end = min(q + chunk, hi[b])
            if q >= hi[b]:
                q, tail = tail, tail + chunk
                end = min(q + chunk, n_items)
            if q >= end:
                empty += 1
                for s in items[w]:        # then the staged items
                    hits[s] += 1
                active[i] = active[-1]
                active.pop()
                continue
        hits[q] += 1
        span[w] = (q + 1, end)
    n4 = m_local // 4
    spans = []
    for b in range(grid):
        z, z1 = n4 * b // grid, n4 * (b + 1) // grid
        spans += [(4 * a, 4 * min(a + ZERO_F4, z1))
                  for a in range(z, z1, ZERO_F4)]
    spans.append((4 * n4, m_local))
    return {"staged": staged.view(-1, n_tiles), "hits": hits.view(-1, n_tiles),
            "columns": columns, "rounds": torch.tensor(used), "n_own": n_own,
            "empty": empty, "fill": torch.tensor(spans, dtype=torch.int64)}


def weight_grad_lanes(e: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """e [B, L, d] (the gathered rows M[loc[b, l]]), g [B, d] -> dw [B, L]
    in the kernel's order of sums."""
    B, L, d = e.shape
    prod = e * g[:, None, :]
    lanes = torch.zeros((B, L, WARP), dtype=e.dtype, device=e.device)
    for c0 in range(0, d, WARP):
        w = min(WARP, d - c0)
        lanes[..., :w] = lanes[..., :w] + prod[..., c0:c0 + w]
    lane = torch.arange(WARP, device=e.device)
    off = WARP // 2
    while off:
        lanes = lanes + lanes[..., lane ^ off]
        off //= 2
    return lanes[..., 0].contiguous()


# ----------------------------------- the sparse optimizers' row layout

def row_geometry(d: int, W: int) -> tuple[int, int]:
    """(LPR, UPL) of ``launch_rows``: a row padded to a power of two of
    columns is width / W units, over LPR lanes with UPL units each."""
    width = 1 << max(d - 1, 0).bit_length()
    units = width // W
    lpr = min(WARP, units)
    return lpr, units // lpr


def row_tree(x: torch.Tensor, W: int) -> torch.Tensor:
    """x [n, d] -> the row-wise mean's sum of each row as ``row_tree`` in
    the kernel adds it: columns in lane l, unit k, float c at
    (l + k LPR) W + c; the units of a lane halved first, then the lanes by
    xor shuffles, then the floats of a unit; divided by d."""
    n, d = x.shape
    lpr, upl = row_geometry(d, W)
    X = torch.nn.functional.pad(x, (0, upl * lpr * W - d)).reshape(
        n, upl, lpr, W)
    h = upl // 2
    while h:
        X = torch.cat([X[:, :h] + X[:, h:2 * h], X[:, h:]], 1)
        h //= 2
    lane = torch.arange(lpr)
    off = lpr // 2
    while off:
        X = X + X[:, :, lane ^ off]
        off //= 2
    if W == 4:
        c0, c1 = X[..., 0] + X[..., 2], X[..., 1] + X[..., 3]
        X = (c0 + c1)[..., None]
    return sref.div(X[:, 0, 0, 0], d)


class _Carry:
    """The fold's carry stack (its register and shared levels are one stack
    arithmetically): slot k holds a block of 2^k pushed leaves."""

    def __init__(self):
        self.c, self.count = {}, 0

    def push(self, x):
        k = 0
        while (self.count >> k) & 1:
            x = self.c[k] + x
            k += 1
        self.c[k] = x
        self.count += 1

    def finish(self):
        acc = None
        for k in sorted(self.c):
            if (self.count >> k) & 1:
                acc = self.c[k] if acc is None else self.c[k] + acc
        return acc


def _tree8(block: torch.Tensor, n: int) -> torch.Tensor:
    """The truncated aligned tree of block[0:n] ([8, d], zero past n)."""
    e = list(block)
    for step in (1, 2, 4):
        for i in range(0, FOLD_BLOCK, 2 * step):
            if i + step < n:
                e[i] = e[i] + e[i + step]
    return e[0]


def _fold_run(idx: torch.Tensor, vals: torch.Tensor, h: int) -> torch.Tensor:
    """The run of idx[h] from its head h, as fold_run takes it."""
    K, row = idx.numel(), int(idx[h])
    carry, n, base = _Carry(), 0, h
    while True:
        seg = idx[base:base + FOLD_BLOCK]
        cnt = int((seg == row).cumprod(0).sum()) if seg.numel() else 0
        if cnt == 0:
            break
        block = torch.zeros((FOLD_BLOCK,) + vals.shape[1:], dtype=vals.dtype)
        block[:cnt] = vals[base:base + cnt]
        carry.push(_tree8(block, cnt))
        n += cnt
        if cnt < FOLD_BLOCK:
            break
        base += FOLD_BLOCK
    s = carry.finish()
    return s if n == K and n & (n - 1) == 0 else s + torch.zeros((),
                                                                 dtype=s.dtype)


def row_fold_schedule(idx: torch.Tensor, vals: torch.Tensor, rows=None):
    """-> (head [K], folded [K, d]) as the bucketed row kernel computes
    them: each span of 32 entries flags its heads (against the entry before
    the span) and folds the runs of its live heads (idx < rows; every head
    when rows is None), reading past the span's end; 0 everywhere else."""
    K = idx.numel()
    head = torch.zeros(K, dtype=torch.bool)
    out = torch.zeros_like(vals)
    for s0 in range(0, K, SPAN):
        seg = idx[s0:s0 + SPAN]
        prev = torch.cat([idx[s0 - 1:s0] if s0 else ~seg[:1], seg[:-1]])
        for j in torch.nonzero(seg != prev).flatten().tolist():
            head[s0 + j] = True
            if rows is None or 0 <= int(seg[j]) < rows:
                out[s0 + j] = _fold_run(idx, vals, s0 + j)
    return head, out


def row_update_schedule(algo: str, idx, vals, states: tuple, *, unique,
                        **hyper):
    """The row kernel's update: each live head's value (the entry itself,
    or its run's sum by ``row_fold_schedule``) through the plain op, every
    other entry's update 0, states updated in place at the live heads.
    -> the update values."""
    rows = states[0].shape[0]
    if unique:
        live, s = idx < rows, vals
    else:
        head, s = row_fold_schedule(idx, vals, rows)
        live = head & (idx < rows)
    only = torch.where(live, idx, torch.full_like(idx, rows))
    u, _ = getattr(sref, f"sparse_{algo}_ref")(only, s, *states, unique=True,
                                               **hyper)
    return u


# ------------------------------------------------------ the embedding bag

def fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 tensors, rounded once to float32 (CUDA's
    fmaf): the float64 product is exact, the float64 sum s carries its
    rounding error exactly (TwoSum), and where s lies halfway between two
    float32 values the error decides the side."""
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)
    r = s.float()
    r64 = r.double()
    up = s > r64
    inf = torch.full_like(r, float("inf"))
    other = torch.nextafter(r, torch.where(up, inf, -inf))
    mid = (s != r64) & (s == (r64 + other.double()) * 0.5)
    away = mid & (err != 0) & ((err > 0) == up)
    return torch.where(away, other, r)


def bag_fma_chain(table: torch.Tensor, ids: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """[B, d]: acc = fmaf(w[b, l], T[ids[b, l]], acc) for l in order from 0,
    an id outside [0, V) skipped, as every column of the kernel sums."""
    B, L = ids.shape
    V, d = table.shape
    acc = torch.zeros((B, d), dtype=torch.float32, device=table.device)
    for l in range(L):
        i = ids[:, l].long()
        ok = (i >= 0) & (i < V)
        row = table[i.clamp(0, V - 1)]
        nxt = fmaf(w[:, l, None].expand(B, d), row, acc)
        acc = torch.where(ok[:, None], nxt, acc)
    return acc
