"""The port's sparse Adagrad plain version against the JAX reference on the
CPU: ``fold_duplicates`` and ``sparse_adagrad_ref`` are copies of the
reference's, operation for operation, so both hold bit for bit (values
compared with ``np.array_equal``), for sentinel-padded unique streams and
sorted streams with duplicate runs, one of them 2^15 entries long.
Slots no index touches keep their accumulator bits."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kernel_schedules import (row_fold_schedule, row_geometry,  # noqa: E402
                              row_tree, row_update_schedule)
from repro.kernels.sparse_update import ref as jref  # noqa: E402
from repro_torch.kernels.sparse_update import ops as tops  # noqa: E402
from repro_torch.kernels.sparse_update import ref as tref  # noqa: E402

M = 4096
LONG_RUN = 1 << 15


def _stream(seed: int, unique: bool):
    """Sorted indices [K] and values [K] float32 (values 1e-6..1 in
    magnitude, both signs).  unique: distinct slots + a sentinel tail.
    Else: duplicate runs of random length, one of LONG_RUN entries."""
    rng = np.random.default_rng(seed)
    if unique:
        live = np.sort(rng.choice(M, 900, replace=False)).astype(np.int32)
        idx = np.concatenate([live, np.full(124, M, np.int32)])
        vals = rng.normal(0, 1, idx.shape[0]).astype(np.float32)
        vals[live.shape[0]:] = 0.0
        return idx, vals
    slots = np.sort(rng.choice(M, 700, replace=False))
    runs = rng.geometric(0.3, slots.shape[0])
    runs[rng.integers(0, slots.shape[0])] = LONG_RUN
    idx = np.repeat(slots, runs).astype(np.int32)
    vals = (rng.normal(0, 1, idx.shape[0])
            * 10.0 ** rng.uniform(-6, 0, idx.shape[0])).astype(np.float32)
    return idx, vals


@pytest.mark.parametrize("seed", [0, 1])
def test_fold_duplicates_bitwise(seed):
    idx, vals = _stream(seed, unique=False)
    assert np.bincount(idx).max() >= LONG_RUN
    jh, jv = jref.fold_duplicates(jnp.asarray(idx), jnp.asarray(vals))
    th, tv = tref.fold_duplicates(torch.from_numpy(idx),
                                  torch.from_numpy(vals))
    assert np.array_equal(np.asarray(jh), th.numpy())
    assert np.array_equal(np.asarray(jv), tv.numpy())


@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("initial", [0.0, 0.25])
def test_sparse_adagrad_ref_bitwise(unique, initial):
    idx, vals = _stream(3, unique)
    rng = np.random.default_rng(4)
    acc0 = (initial * rng.random(M)).astype(np.float32)
    ju, (jacc,) = jref.sparse_adagrad_ref(
        jnp.asarray(idx), jnp.asarray(vals), jnp.asarray(acc0), lr=0.01,
        eps=1e-10, unique=unique)
    tacc = torch.from_numpy(acc0.copy())
    tu, (tacc_out,) = tops.sparse_update(
        "adagrad", torch.from_numpy(idx), torch.from_numpy(vals), (tacc,),
        unique=unique, lr=0.01, eps=1e-10)
    assert tacc_out is tacc                      # updated in place
    assert np.array_equal(np.asarray(ju), tu.numpy())
    assert np.array_equal(np.asarray(jacc), tacc.numpy())
    touched = np.zeros(M, bool)
    touched[idx[idx < M]] = True
    assert np.array_equal(acc0.view(np.int32)[~touched],
                          tacc.numpy().view(np.int32)[~touched])
    assert (tu.numpy()[idx >= M] == 0).all()


def test_non_heads_and_sentinels_carry_zero_updates():
    idx = torch.tensor([2, 2, 2, 5, 7, 7], dtype=torch.int32)
    vals = torch.tensor([1.0, 2.0, 3.0, -1.0, 0.5, 0.5])
    acc = torch.zeros(8)
    u, _ = tref.sparse_adagrad_ref(idx, vals, acc, lr=0.1, unique=False)
    assert (u[[1, 2, 5]] == 0).all() and (u[[0, 3, 4]] != 0).all()
    assert acc.tolist() == [0, 0, 36.0, 0, 0, 1.0, 0, 1.0]
    idx_s = torch.tensor([1, 3, 8, 8], dtype=torch.int32)   # sentinel = 8
    u, _ = tref.sparse_adagrad_ref(idx_s, torch.tensor([1.0, 1.0, 0, 0]),
                                   torch.zeros(8), lr=0.1, unique=True)
    assert u[2:].tolist() == [0.0, 0.0]


def test_only_adagrad_is_ported():
    """Once only Adagrad was ported; now the dispatch takes exactly the
    reference's algorithms and layouts (``ops._shapes_ok``) and raises for
    anything else."""
    assert tops.ALGOS == ("sgd", "adagrad", "adam")
    idx = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError):
        tops.sparse_update("adafactor", idx, torch.zeros(1),
                           (torch.zeros(4),), lr=0.1)
    with pytest.raises(ValueError):         # 1-D SGD state, [K, d] values
        tops.sparse_update("sgd", idx, torch.zeros(1, 2), (torch.zeros(4),),
                           lr=0.1, momentum=0.9)
    with pytest.raises(ValueError):         # 1-D Adagrad state, [K, d] values
        tops.sparse_update("adagrad", idx, torch.zeros(1, 2),
                           (torch.zeros(4),), lr=0.1)
    u, st = tops.sparse_update("adam", idx, torch.ones(1, 2),
                               (torch.zeros(4, 2), torch.zeros(4)), lr=0.1)
    assert u.shape == (1, 2) and len(st) == 2   # row-wise nu: Adam only


# ------------------------------------------ rows 8, 9: sparse SGD and Adam

ROWS = 512


def _states(rng, algo, shape, rowwise=False):
    if algo == "sgd":
        return (rng.normal(size=shape).astype(np.float32),)
    nu_shape = shape[:1] if rowwise else shape
    return ((rng.normal(size=shape) * 1e-3).astype(np.float32),
            (rng.random(nu_shape) * 1e-6).astype(np.float32))


def _row_stream(seed: int, unique: bool, d: int):
    """The row layout: sorted row ids [K] (a sentinel tail, or duplicate
    runs up to 40 long) and values [K, d]."""
    rng = np.random.default_rng(seed)
    if unique:
        live = np.sort(rng.choice(ROWS, 300, replace=False)).astype(np.int32)
        idx = np.concatenate([live, np.full(45, ROWS, np.int32)])
    else:
        slots = np.sort(rng.choice(ROWS, 150, replace=False))
        runs = rng.geometric(0.2, slots.shape[0])
        runs[:2] = (40, 33)
        idx = np.repeat(slots, runs).astype(np.int32)
    vals = (rng.normal(0, 1, (idx.shape[0], d))
            * 10.0 ** rng.uniform(-6, 0, (idx.shape[0], 1))).astype(np.float32)
    vals[idx >= ROWS] = 0.0
    return idx, vals


ADAM = dict(lr=0.01, b1=0.9, b2=0.999, bc1=float(np.float32(0.271)),
            bc2=float(np.float32(0.00299)), eps=1e-8)


def _both(algo, idx, vals, states, unique, **hyper):
    """The reference's jnp version (op by op) and the port's dispatch on the
    same inputs -> (reference update, states), (port update, states)."""
    jfn = {"sgd": jref.sparse_sgd_ref, "adam": jref.sparse_adam_ref}[algo]
    ju, jst = jfn(jnp.asarray(idx), jnp.asarray(vals),
                  *map(jnp.asarray, states), unique=unique, **hyper)
    tst = tuple(torch.from_numpy(s.copy()) for s in states)
    tu, out = tops.sparse_update(algo, torch.from_numpy(idx),
                                 torch.from_numpy(vals), tst, unique=unique,
                                 **hyper)
    assert all(a is b for a, b in zip(out, tst))        # updated in place
    return (np.asarray(ju), [np.asarray(s) for s in jst]), \
        (tu.numpy(), [s.numpy() for s in tst])


def _untouched_unchanged(idx, states, tst):
    lead = states[0].shape[0]
    touched = np.zeros(lead, bool)
    touched[idx[idx < lead]] = True
    for s0, s in zip(states, tst):
        assert np.array_equal(s0[~touched].view(np.int32),
                              s[~touched].view(np.int32))


@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("algo", ["sgd", "adam"])
def test_sparse_sgd_adam_ref_flat_bitwise(algo, unique):
    """Flat [m] states, sentinel-padded unique streams and sorted streams
    with duplicate runs (one 2^15 long): updates and states bit-equal to the
    reference's jnp version; untouched slots keep their bits."""
    idx, vals = _stream(5, unique)
    states = _states(np.random.default_rng(6), algo, (M,))
    hyper = ADAM if algo == "adam" else dict(lr=0.01, momentum=0.9)
    (ju, jst), (tu, tst) = _both(algo, idx, vals, states, unique, **hyper)
    assert np.array_equal(ju, tu)
    for a, b in zip(jst, tst):
        assert np.array_equal(a, b)
    _untouched_unchanged(idx, states, tst)
    assert (tu[idx >= M] == 0).all()


@pytest.mark.parametrize("d", [8, 5])
@pytest.mark.parametrize("unique", [True, False])
@pytest.mark.parametrize("algo,rowwise", [("sgd", False), ("adam", False),
                                          ("adam", True)])
def test_sparse_sgd_adam_ref_rows_bitwise(algo, rowwise, unique, d):
    """[rows, d] states with [K, d] values (the row-mode SparseGrad), d a
    power of two and not: bit-equal to the reference, except Adam's
    row-wise nu [rows], whose row mean the port sums in a fixed tree order
    (``ref.row_mean``, which the kernel follows) and XLA in its own, so that
    value and the updates that divide by it are held to 1e-6 relative."""
    idx, vals = _row_stream(d, unique, d)
    states = _states(np.random.default_rng(d + 1), algo, (ROWS, d), rowwise)
    hyper = ADAM if algo == "adam" else dict(lr=0.01, momentum=0.9)
    (ju, jst), (tu, tst) = _both(algo, idx, vals, states, unique, **hyper)
    if rowwise:
        np.testing.assert_allclose(tu, ju, rtol=1e-6, atol=0)
        np.testing.assert_allclose(tst[1], jst[1], rtol=1e-6, atol=0)
        assert np.array_equal(tst[0], jst[0])           # mu: bitwise
    else:
        assert np.array_equal(ju, tu)
        for a, b in zip(jst, tst):
            assert np.array_equal(a, b)
    _untouched_unchanged(idx, states, tst)


def test_sgd_without_momentum_has_no_state():
    idx, vals = _stream(7, unique=False)
    u, st = tops.sparse_update("sgd", torch.from_numpy(idx),
                               torch.from_numpy(vals), (), lr=0.5)
    ju, jst = jref.sparse_sgd_ref(jnp.asarray(idx), jnp.asarray(vals), None,
                                  lr=0.5)
    assert st == () == jst and np.array_equal(np.asarray(ju), u.numpy())


def test_row_mean_fixed_order():
    """``row_mean`` adds halves of a zero-padded power-of-two row, so it
    differs from a left-to-right sum only by rounding and is exact on
    values whose sums are exact."""
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0, 5.0], [0.5] * 5])
    assert tref.row_mean(x).tolist() == [3.0, 0.5]
    rng = np.random.default_rng(8)
    y = rng.random((40, 100)).astype(np.float32)
    np.testing.assert_allclose(tref.row_mean(torch.from_numpy(y)).numpy(),
                               y.astype(np.float64).mean(1), rtol=1e-6)


@pytest.mark.parametrize("algo,rowwise", [("sgd", False), ("adam", False),
                                          ("adam", True)])
def test_sparse_update_matches_pallas_interpret(algo, rowwise):
    """Against the reference's Pallas kernel in interpret mode, on the
    reference test's inputs and at its tolerance (atol 1e-6,
    ``tests/test_sparse_update.py::test_pallas_kernel_matches_ref_row_mode``):
    XLA compiles the interpreted kernel body as one program and contracts
    some ``a * b + c`` into fused multiply-adds (measured on this CPU), which
    the port's version, like the reference's op-by-op jnp one, does not."""
    from repro.kernels.sparse_update import ops as jops
    rng = np.random.default_rng(5)
    rows, d, k = 128, 8, 32
    live = np.sort(rng.choice(rows, 20, replace=False)).astype(np.int32)
    idx = np.concatenate([live, np.full(k - 20, rows, np.int32)])
    vals = rng.normal(size=(k, d)).astype(np.float32)
    vals[20:] = 0.0
    if rowwise or algo == "sgd":
        shape = (rows, d)
    else:
        shape, vals = (rows * d // 4,), vals.reshape(-1)[:k]
        idx = np.concatenate([np.sort(rng.choice(shape[0], 20,
                                                 replace=False)),
                              np.full(k - 20, shape[0])]).astype(np.int32)
        vals[20:] = 0.0
    states = _states(rng, algo, shape, rowwise)
    hyper = ({"lr": 0.1, "momentum": 0.9} if algo == "sgd" else
             dict(lr=0.1, b1=0.9, b2=0.99, bc1=0.5, bc2=0.2, eps=1e-8))
    ju, jst = jops.sparse_update(algo, jnp.asarray(idx), jnp.asarray(vals),
                                 tuple(map(jnp.asarray, states)),
                                 interpret=True, **hyper)
    tst = tuple(torch.from_numpy(s.copy()) for s in states)
    tu, _ = tops.sparse_update(algo, torch.from_numpy(idx),
                               torch.from_numpy(vals), tst, **hyper)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-6)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    _untouched_unchanged(idx, states, [s.numpy() for s in tst])


# ------------------------- the flat fold's schedule (csrc/sparse_update.cu)
#
# A plain-PyTorch emulation of the CUDA fold's order of additions: tiles of
# warps * lanes * span entries with a halo read in steps of warps * lanes,
# windows of `lanes` entries folded by the reference's masked doubling
# (shuffle-down semantics), for a run that leaves its window one lane an
# entry if it ends within `lanes` entries, else head-aligned rounds of
# lanes * span entries (span-trees, then a lane tree, then a carry stack),
# and pass 2's chunks of warps rounds for a run that covers the
# halo.  The kernel's constants are lanes 32, span 8, warps 8, halo 2,048.

class _Carry:
    """The kernel's carry stack: slot k holds a block of 2^k leaves."""

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


def _tree(leaves: list, n: int):
    """Truncated aligned tree of leaves[0:n] (len(leaves) a power of two):
    leaf i + step joins leaf i where i is a multiple of 2 step."""
    leaves = list(leaves)
    step = 1
    while step < len(leaves):
        for i in range(0, len(leaves), 2 * step):
            if i + step < n:
                leaves[i] = leaves[i] + leaves[i + step]
        step *= 2
    return leaves[0]


def _round(vals, lanes: int, span: int, cnt: int):
    """One warp's fold of cnt entries (vals, a float32 tensor, zero past
    cnt) as span-trees a lane, then the shuffle tree over the lanes."""
    lane_sums = [_tree(list(vals[span * ln:span * (ln + 1)]),
                       min(max(cnt - span * ln, 0), span))
                 for ln in range(lanes)]
    return _tree(lane_sums, -(-cnt // span))


def _as_reference(s, n: int, K: int):
    return s if n == K and n & (n - 1) == 0 else s + torch.zeros((),
                                                                 dtype=s.dtype)


def _in_run(idx, vals, start: int, width: int, slot: int, limit: int):
    """Entries [start, start + width) of the run of `slot` (those before
    limit), zero past it; -> (values, count)."""
    seg = idx[start:min(start + width, limit)]
    same = seg == slot
    cnt = int(same.cumprod(0).sum()) if seg.numel() else 0
    out = torch.zeros(width, dtype=vals.dtype)
    out[:cnt] = vals[start:start + cnt]
    return out, cnt


def _schedule_fold(idx, vals, lanes=32, span=8, warps=8, halo=2048):
    """-> (head, folded) as ``fold_duplicates`` gives them, computed in the
    CUDA fold's order."""
    K = idx.numel()
    rnd, threads = lanes * span, warps * lanes
    tile = warps * rnd
    head = torch.ones(K, dtype=torch.bool)
    head[1:] = idx[1:] != idx[:-1]
    out = torch.zeros(K, dtype=vals.dtype)
    long_heads = []
    for ts in range(0, K, tile):
        n_tile = min(tile, K - ts)
        n_buf, long_run = n_tile, False
        tail = int(idx[ts + n_tile - 1])
        if n_tile == tile and ts + tile < K and int(idx[ts + tile]) == tail:
            long_run, q0 = True, tile
            while q0 < tile + halo and long_run:
                seg = idx[ts + q0:ts + q0 + threads]
                long_run = seg.numel() == threads and bool((seg == tail).all())
                n_buf = min(K - ts, q0 + threads)
                q0 += threads
        tile_heads = torch.nonzero(head[ts:ts + n_tile]).flatten()
        last = int(tile_heads[-1]) if tile_heads.numel() else -1
        long_lh = last if long_run else -1
        if long_lh >= 0:
            long_heads.append(ts + long_lh)
        for w0 in range(0, n_tile, lanes):
            nv = min(lanes, n_tile - w0)
            hm = head[ts + w0:ts + w0 + nv]
            if not hm.any():
                continue
            lane_heads = [ln for ln in range(nv) if hm[ln]]
            x = torch.zeros(lanes, dtype=vals.dtype)
            x[:nv] = vals[ts + w0:ts + w0 + nv]
            hl = torch.tensor([max([h for h in lane_heads if h <= ln],
                                   default=-1) for ln in range(lanes)])
            end = torch.tensor([min([h for h in lane_heads if h > ln],
                                    default=nv) for ln in range(lanes)])
            r, rem = torch.arange(lanes) - hl, end - torch.arange(lanes)
            off = 1
            while off < lanes:
                y = torch.cat([x[off:], x[lanes - off:]])
                x = torch.where((hl >= 0) & ((r & (2 * off - 1)) == 0)
                                & (off < rem), x + y, x)
                off *= 2
            p_last = ts + w0 + nv - 1
            goes_on = p_last + 1 < K and int(idx[p_last + 1]) == int(
                idx[p_last])
            hc = lane_heads[-1]
            for ln in lane_heads:
                if ln == hc and goes_on:
                    continue
                out[ts + w0 + ln] = _as_reference(x[ln], int(rem[ln]), K)
            if goes_on and w0 + hc != long_lh:
                slot, carry, n = int(idx[ts + w0 + hc]), _Carry(), 0
                base = ts + w0 + hc
                seg, cnt = _in_run(idx, vals, base, lanes + 1, slot,
                                   ts + n_buf)
                if cnt <= lanes:              # a lane an entry
                    out[base] = _as_reference(_round(seg, lanes, 1, cnt),
                                              cnt, K)
                    continue
                while True:
                    seg, cnt = _in_run(idx, vals, base, rnd, slot, ts + n_buf)
                    if cnt == 0:
                        break
                    carry.push(_round(seg, lanes, span, cnt))
                    n += cnt
                    if cnt < rnd:
                        break
                    base += rnd
                out[ts + w0 + hc] = _as_reference(carry.finish(), n, K)
    for h in long_heads:                                    # pass 2
        slot, carry, n, base = int(idx[h]), _Carry(), 0, h
        while True:
            sums, total = [], 0
            for w in range(warps):
                seg, cnt = _in_run(idx, vals, base + w * rnd, rnd, slot, K)
                sums.append(_round(seg, lanes, span, cnt))
                total += cnt
            if total > 0:
                carry.push(_tree(sums, -(-total // rnd)))
                n += total
            if total < tile:
                break
            base += tile
        out[h] = _as_reference(carry.finish(), n, K)
    return head, out


def _edge_stream(seed: int, edge: int, longest: int, n_runs: int):
    """Sorted slots whose runs take every length 1..longest + 1 with run
    ends placed on and around every multiple of `edge`, values of both
    signs and scales, some -0 and +0."""
    rng = np.random.default_rng(seed)
    lengths = list(range(1, longest + 2)) + list(rng.integers(
        1, 2 * longest, n_runs))
    rng.shuffle(lengths)
    lengths = [int(n) for n in lengths]
    idx = np.repeat(np.arange(len(lengths), dtype=np.int32) * 3, lengths)
    vals = (rng.normal(0, 1, idx.shape[0])
            * 10.0 ** rng.uniform(-6, 2, idx.shape[0])).astype(np.float32)
    vals[rng.random(idx.shape[0]) < 0.05] = -0.0
    vals[rng.random(idx.shape[0]) < 0.02] = 0.0
    return idx, vals


def _fold_bits(fold, idx, vals):
    h, v = fold(idx, vals)
    return np.asarray(h), np.asarray(v).view(np.int32)


@pytest.mark.parametrize("case", ["small", "kernel", "one", "whole",
                                  "negzero_pow2", "negzero_odd"])
def test_flat_fold_schedule_matches_fold_duplicates(case):
    """The CUDA flat fold's order of additions, emulated, gives the bits of
    the reference's and the port's ``fold_duplicates`` (signed zeros too):
    small lanes and tiles make runs cross every tile edge, fill the halo
    and go to pass 2 over many rounds; the kernel's own constants on a
    stream with runs past its 2,048-entry halo; K = 1; one run as the
    whole stream; all -0 runs."""
    lanes, span, warps, halo = (4, 2, 2, 16) if case == "small" else \
        (32, 8, 8, 2048)
    if case in ("small", "kernel"):
        tile = lanes * span * warps
        idx, vals = _edge_stream(7, tile, 3 * (tile + halo) if case ==
                                 "small" else 300, 60 if case == "small"
                                 else 40)
        if case == "kernel":          # runs across the halo, to pass 2
            idx = np.concatenate([idx, np.repeat(np.int32(idx[-1] + 3),
                                                 5000),
                                  np.repeat(np.int32(idx[-1] + 6), 2049)])
            vals = np.concatenate([vals, np.random.default_rng(8).normal(
                0, 1, 7049).astype(np.float32)])
    elif case == "one":
        idx, vals = np.array([4], np.int32), np.array([-0.0], np.float32)
    elif case == "whole":
        idx = np.full(700, 9, np.int32)
        vals = np.random.default_rng(2).normal(0, 1, 700).astype(np.float32)
    else:
        n = 64 if case == "negzero_pow2" else 63
        idx, vals = np.full(n, 1, np.int32), np.full(n, -0.0, np.float32)
    want = _fold_bits(lambda i, v: jref.fold_duplicates(jnp.asarray(i),
                                                        jnp.asarray(v)),
                      idx, vals)
    port = _fold_bits(lambda i, v: tref.fold_duplicates(torch.from_numpy(i),
                                                        torch.from_numpy(v)),
                      idx, vals)
    mine = _fold_bits(lambda i, v: _schedule_fold(
        torch.from_numpy(i), torch.from_numpy(v), lanes, span, warps, halo),
        idx, vals)
    for got in (port, mine):
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1])


# ------------------------- the row kernels' walk (csrc/sparse_update.cu)
#
# The row layout's kernels, emulated in ``tests/kernel_schedules.py``:
# spans of 32 entries, heads flagged against the entry before the span, each
# live head's run folded in head-aligned blocks of 8 through a carry stack
# (runs that cross span edges read past them), ``as_reference`` on every
# sum; the row-wise mean's tree over the kernel's lanes and units.

def _row_walk_stream(seed: int, kind: str, d: int):
    """``unique``: distinct sorted rows, a sentinel tail, every seventh
    entry all -0.  ``bucketed``: runs of every length 1..40 in random order
    and one of 150 (run ends at every offset of a span, runs across several
    spans), then a sentinel tail.  ``negzero``: runs of 1..24, 1% of the
    values -0, every entry of length 1 all -0 and one column -0 through
    every third run.  -> (indices, values)."""
    rng = np.random.default_rng(seed)
    if kind == "unique":
        live = np.sort(rng.choice(ROWS, 200, replace=False)).astype(np.int32)
        idx = np.concatenate([live, np.full(37, ROWS, np.int32)])
        lengths = None
    else:
        top = 41 if kind == "bucketed" else 25
        lengths = np.concatenate([rng.permutation(np.arange(1, top)),
                                  [150] if kind == "bucketed" else []])
        lengths = rng.permutation(lengths).astype(np.int64)
        slots = np.sort(rng.choice(ROWS, lengths.shape[0], replace=False))
        idx = np.concatenate([np.repeat(slots, lengths),
                              np.full(29, ROWS)]).astype(np.int32)
    vals = (rng.normal(0, 1, (idx.shape[0], d))
            * 10.0 ** rng.uniform(-6, 1, (idx.shape[0], 1))).astype(np.float32)
    if kind == "unique":
        vals[::7] = -0.0
    if kind == "negzero":
        vals[rng.random(vals.shape) < 0.01] = -0.0
        starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        vals[starts[lengths == 1]] = -0.0
        for r in range(0, lengths.shape[0], 3):
            vals[starts[r]:starts[r] + lengths[r], rng.integers(d)] = -0.0
    vals[idx >= ROWS] = 0.0
    return idx, vals


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("kind", ["bucketed", "negzero", "whole_negzero",
                                  "one"])
@pytest.mark.parametrize("d", [5, 8, 64, 100])
def test_row_fold_schedule_matches_fold_duplicates(d, kind):
    """The bucketed row kernel's walk gives the bits of the reference's and
    the port's ``fold_duplicates`` at every head, signed zeros too: runs
    across span edges and a run of 150 over five spans, lone and all -0
    runs, one all -0 run that is the whole stream (64 entries, the one case
    the reference keeps -0), K = 1."""
    if kind == "whole_negzero":
        idx, vals = np.full(64, 3, np.int32), np.full((64, d), -0.0,
                                                     np.float32)
    elif kind == "one":
        idx, vals = np.array([3], np.int32), np.full((1, d), -0.0, np.float32)
    else:
        idx, vals = _row_walk_stream(d, kind, d)
    jh, jv = jref.fold_duplicates(jnp.asarray(idx), jnp.asarray(vals))
    th, tv = tref.fold_duplicates(torch.from_numpy(idx),
                                  torch.from_numpy(vals))
    mh, mv = row_fold_schedule(torch.from_numpy(idx), torch.from_numpy(vals))
    for h, v in ((th, tv), (mh, mv)):
        assert np.array_equal(np.asarray(jh), h.numpy())
        assert np.array_equal(_bits(jv), _bits(v.numpy()))


@pytest.mark.parametrize("kind", ["unique", "bucketed", "negzero"])
@pytest.mark.parametrize("d", [5, 8, 64, 100])
@pytest.mark.parametrize("algo,rowwise", [("sgd", False), ("adagrad", False),
                                          ("adam", False), ("adam", True)])
def test_row_update_schedule_matches_reference(algo, rowwise, d, kind):
    """The row kernel's update, emulated (its walk's sums through the
    plain op), against the port's plain version and the live reference's
    jnp version (op by op) on the same inputs: updates and states bit-equal,
    compared as int32 patterns, untouched slots unchanged; Adam's row-wise
    nu and the updates that divide by it are held to the reference to 1e-6
    relative (XLA's mean sums in its own order; ``ref.row_mean``), and
    bitwise to the port's plain version."""
    idx, vals = _row_walk_stream(100 + d, kind, d)
    unique = kind == "unique"
    states = _states(np.random.default_rng(d), algo if algo != "adagrad"
                     else "sgd", (ROWS, d), rowwise)
    if algo == "adagrad":
        states = (np.abs(states[0]),)
    hyper = {"sgd": dict(lr=0.01, momentum=0.9), "adam": ADAM,
             "adagrad": dict(lr=0.01, eps=1e-10)}[algo]
    jfn = getattr(jref, f"sparse_{algo}_ref")
    ju, jst = jfn(jnp.asarray(idx), jnp.asarray(vals),
                  *map(jnp.asarray, states), unique=unique, **hyper)
    plain = tuple(torch.from_numpy(x.copy()) for x in states)
    pu, _ = getattr(tref, f"sparse_{algo}_ref")(
        torch.from_numpy(idx), torch.from_numpy(vals), *plain, unique=unique,
        **hyper)
    mine = tuple(torch.from_numpy(x.copy()) for x in states)
    mu_ = row_update_schedule(algo, torch.from_numpy(idx),
                              torch.from_numpy(vals), mine, unique=unique,
                              **hyper)
    assert np.array_equal(_bits(mu_.numpy()), _bits(pu.numpy()))
    for a, b in zip(mine, plain):
        assert np.array_equal(_bits(a.numpy()), _bits(b.numpy()))
    if rowwise:
        np.testing.assert_allclose(mu_.numpy(), np.asarray(ju), rtol=1e-6,
                                   atol=0)
        np.testing.assert_allclose(mine[1].numpy(), np.asarray(jst[1]),
                                   rtol=1e-6, atol=0)
        assert np.array_equal(_bits(mine[0].numpy()), _bits(jst[0]))
    else:
        assert np.array_equal(_bits(mu_.numpy()), _bits(ju))
        for a, b in zip(mine, jst):
            assert np.array_equal(_bits(a.numpy()), _bits(b))
    _untouched_unchanged(idx, states, [x.numpy() for x in mine])


@pytest.mark.parametrize("d,W", [(d, 1) for d in (1, 5, 8, 12, 64, 100, 256)]
                         + [(d, 4) for d in (8, 12, 64, 100, 256)])
def test_row_tree_matches_row_mean(d, W):
    """The row-wise mean's tree as the kernel lays a row over lanes and
    units (``row_geometry``: a d = 64 row of float4s on a half-warp; W = 4
    only where d % 4 == 0) gives ``ref.row_mean``'s bits, which the plain
    version and the kernel share."""
    lpr, upl = row_geometry(d, W)
    assert lpr * upl * W >= d and lpr <= 32 and lpr & (lpr - 1) == 0
    if (d, W) == (64, 4):
        assert (lpr, upl) == (16, 1)
    rng = np.random.default_rng(d)
    x = torch.from_numpy((rng.normal(0, 1, (50, d))
                          * 10.0 ** rng.uniform(-8, 8, (50, d)))
                         .astype(np.float32))
    assert torch.equal(row_tree(x, W).view(torch.int32),
                       tref.row_mean(x).view(torch.int32))
