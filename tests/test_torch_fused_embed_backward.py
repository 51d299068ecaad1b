"""The fused engine's backward-side plain versions (CPU path) against the
JAX fused engine (Pallas in interpret mode): locations bit-identical to
``fused_locations``; the scatter-add and the bag weight gradient within
1e-6 of ``jax.grad`` through ``fused_lookup`` / ``fused_embed_bag`` (float32
sums in another order).  Also the autograd of the port's CPU lookup and bag
against the same gradients; the CUDA weight-gradient kernel's order of
sums, emulated, against the plain version; and the scatter-add kernel's
persistent grid, emulated: its zero fill and its staged and hashed units
each cover their buffer or their (value, column) pairs exactly once."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.allocation import LMAParams as JParams  # noqa: E402
from repro.core.signatures import synthetic_dense_store  # noqa: E402
from repro.kernels.fused_embed import ops as jfe  # noqa: E402
from kernel_schedules import weight_grad_lanes  # noqa: E402
from repro_torch.core.allocation import LMAParams  # noqa: E402
from repro_torch.kernels.fused_embed import ops as fe  # noqa: E402
from repro_torch.kernels.fused_embed import ref as fref  # noqa: E402

N_VALUES, D, M = 512, 16, 8192
TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy((x.view(np.int32) if x.dtype == np.uint32
                             else x).copy())


def _specs(scheme, striped=True):
    if scheme == "lma":
        kw = dict(d=D, m=M, n_h=4, max_set=16, seed=0x8000_0007,
                  striped=striped)
        return fe.lma_spec(LMAParams(**kw)), jfe.lma_spec(JParams(**kw))
    return (fe.hashed_spec(scheme, D, M, 0xFEED_0001),
            jfe.hashed_spec(scheme, D, M, 0xFEED_0001))


def _inputs(seed, shape, scheme):
    """Memory, gids of ``shape`` (+ lma rows and support, fallback rows
    included), and a cotangent for the flat lookup or the bag."""
    rng = np.random.default_rng(seed)
    mem = rng.normal(0, 0.1, M).astype(np.float32)
    gids = rng.integers(0, N_VALUES, shape).astype(np.int32)
    extra = ()
    if scheme == "lma":
        store = synthetic_dense_store(N_VALUES, 8, max_set=16, seed=1)
        support = np.asarray(store.lengths).copy()
        support[::7] = rng.integers(0, 2, len(support[::7]))
        gids.flat[0] = 0                             # a fallback value
        extra = (np.asarray(store.sets)[gids], support[gids])
    g = rng.normal(0, 1, (shape[0], D)).astype(np.float32)
    return rng, mem, gids, extra, g


@pytest.mark.parametrize("scheme,striped", [("lma", False), ("lma", True),
                                            ("hashed_elem", False),
                                            ("hashed_row", False)])
def test_locations_bit_identical(scheme, striped):
    tspec, jspec = _specs(scheme, striped)
    _, _, gids, extra, _ = _inputs(1, (77,), scheme)
    got = fe.fused_locations(tspec, _t(gids), *[_t(a) for a in extra])
    want = jfe.fused_locations(jspec, jnp.asarray(gids),
                               *[jnp.asarray(a) for a in extra],
                               interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# A rank's few-row chunk: which values (index into _inputs' draw, whose
# value 0 is a fallback one under lma)
FEW_ROWS = {"fallback": [0], "minhash": [1], "three": [0, 1, 2]}


@pytest.mark.parametrize("rows", sorted(FEW_ROWS))
@pytest.mark.parametrize("scheme,striped", [("lma", False), ("lma", True),
                                            ("hashed_elem", False),
                                            ("hashed_row", False)])
def test_few_row_locations_bit_identical(scheme, striped, rows):
    """Row 4 at a rank's few-row chunk (1 and 3 rows, the lma fallback row
    alone, a minhash row alone, and both kinds together): the plain
    version bit-identical to the reference's kernel in interpret mode,
    which pads such a chunk to its block of rows."""
    tspec, jspec = _specs(scheme, striped)
    _, _, gids, extra, _ = _inputs(4, (8,), scheme)
    pick = np.asarray(FEW_ROWS[rows])
    gids, extra = gids[pick], tuple(a[pick] for a in extra)
    if scheme == "lma":
        fb = extra[1] < tspec.min_support
        assert list(fb) == [r == 0 for r in FEW_ROWS[rows]]
    got = fref.locations_ref(tspec, _t(gids), *[_t(a) for a in extra])
    want = jfe.fused_locations(jspec, jnp.asarray(gids),
                               *[jnp.asarray(a) for a in extra],
                               interpret=True)
    assert got.shape == (len(pick), D) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scheme", ["lma", "hashed_elem", "hashed_row"])
def test_scatter_add_matches_lookup_gradient(scheme):
    tspec, jspec = _specs(scheme)
    _, mem, gids, extra, g = _inputs(2, (90,), scheme)

    def f(m):
        out = jfe.fused_lookup(jspec, m, jnp.asarray(gids),
                               *[jnp.asarray(a) for a in extra],
                               interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    want = np.asarray(jax.grad(f)(jnp.asarray(mem)))
    got = fref.scatter_add_ref(tspec, _t(g), _t(gids),
                               *[_t(a) for a in extra])
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    tm = _t(mem).requires_grad_()
    fe.fused_lookup(tspec, tm, _t(gids), *[_t(a) for a in extra]).backward(
        _t(g))
    np.testing.assert_allclose(tm.grad.numpy(), want, **TOL)


@pytest.mark.parametrize("scheme", ["lma", "hashed_elem"])
def test_bag_gradients_match(scheme):
    tspec, jspec = _specs(scheme)
    rng, mem, gids, extra, g = _inputs(3, (9, 6), scheme)
    w = (rng.random((9, 6)) < 0.8).astype(np.float32) * rng.random(
        (9, 6), np.float32)

    def f(m, wt):
        out = jfe.fused_embed_bag(jspec, m, jnp.asarray(gids), wt,
                                  *[jnp.asarray(a) for a in extra],
                                  interpret=True)
        return jnp.sum(out * jnp.asarray(g))

    dm, dw = jax.grad(f, argnums=(0, 1))(jnp.asarray(mem), jnp.asarray(w))
    targs = [_t(a) for a in extra]
    got_dm = fref.scatter_add_ref(tspec, _t(g), _t(gids), *targs,
                                  weights=_t(w))
    got_dw = fref.weight_grad_ref(tspec, _t(mem), _t(g), _t(gids), *targs)
    np.testing.assert_allclose(got_dm.numpy(), np.asarray(dm), **TOL)
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(dw), **TOL)
    tm, tw = _t(mem).requires_grad_(), _t(w).requires_grad_()
    fe.fused_embed_bag(tspec, tm, _t(gids), tw, *targs).backward(_t(g))
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(dm), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(dw), **TOL)


@pytest.mark.parametrize("L", [1, 26])
@pytest.mark.parametrize("d", [8, 32, 64])
def test_weight_grad_lane_order_matches_plain(d, L):
    """fused_weight_grad_kernel's order (each lane's columns, product then
    sum, then the xor-shuffle tree; lanes past d add 0), emulated with
    every operation rounded alone, agrees with weight_grad_ref."""
    rng = np.random.default_rng(d * L)
    B = 13
    kw = dict(d=d, m=M, n_h=4, max_set=16, seed=0x8000_0007, striped=True)
    spec = fe.lma_spec(LMAParams(**kw))
    store = synthetic_dense_store(N_VALUES, 8, max_set=16, seed=1)
    support = np.asarray(store.lengths).copy()
    support[::7] = 0                                 # fallback values
    gids = rng.integers(0, N_VALUES, (B, L)).astype(np.int32)
    sets, sup = np.asarray(store.sets)[gids], support[gids]
    mem = _t(rng.normal(0, 0.1, M).astype(np.float32))
    g = _t(rng.normal(0, 1, (B, d)).astype(np.float32))
    loc = fref.locations_ref(spec, _t(gids).reshape(-1),
                             _t(sets).reshape(B * L, -1), _t(sup).reshape(-1))
    e = mem[loc.long()].reshape(B, L, d)
    want = fref.weight_grad_ref(spec, mem, g, _t(gids), _t(sets), _t(sup))
    torch.testing.assert_close(weight_grad_lanes(e, g), want, **TOL)


# ------------------------------ row 5's persistent grid (scatter_schedule)

H100_SMS = 132
# rows, values a row (L), d, the buffer's slots: dlrm-rm2's B = 4,096
# training batch (26 fields) flat, train_4k's 32,768 tokens at d = 2,048 on
# its LMA token table, the bag of 26 fields, an LM decode's 1 and 4 tokens
# on 35f's token table, and a quarter of dlrm-rm2's pool as a rank's slab
SCATTER_SHAPES = {
    "flat_106496x64": (106_496, 1, 64, 135_053_312),
    "train_4k_32768x2048": (32_768, 1, 2_048, 4_096_000),
    "bag_4096x26x64": (4_096, 26, 64, 135_053_312),
    "rows_1x2048": (1, 1, 2_048, 4_096_000),
    "rows_4x2048": (4, 1, 2_048, 4_096_000),
    "slab_quarter_106496x64": (106_496, 1, 64, 135_053_312 // 4),
}


@pytest.mark.parametrize("blocks_per_sm", [6, 8])
@pytest.mark.parametrize("shape", sorted(SCATTER_SHAPES))
def test_scatter_schedule_zeroes_and_emits_once(shape, blocks_per_sm):
    """``fused_scatter_kernel``'s persistent grid, emulated
    (``scatter_schedule``) on every block an H100 holds at 6 or 8 blocks an
    SM, at the tile the wrapper takes (``lookup_tile``), its warps' turns
    at their block's work queue and the grid's tail and its fill's length
    at random: the blocks' bulk copies tile the buffer exactly once, in
    float4s but for the tail; every (value, column) is emitted exactly
    once, staged before the barrier or hashed after; warp 0 (the fill's)
    stages nothing and no warp stages past its 320 slots; only a block's
    own items are staged, and nothing where a value's tile takes more
    than 10 rounds a lane; and each warp ends on exactly one empty
    take."""
    from kernel_schedules import STAGE_ROUNDS, scatter_schedule
    from repro_torch.kernels.fused_embed.kernel import (WARPS_PER_BLOCK,
                                                        lookup_tile)
    rows, L, d, m_local = SCATTER_SHAPES[shape]
    tile = lookup_tile(rows, d, H100_SMS)
    grid = blocks_per_sm * H100_SMS
    s = scatter_schedule(rows, L, d, tile, m_local, grid, seed=blocks_per_sm)
    fill = s["fill"][s["fill"][:, 1] > s["fill"][:, 0]]
    fill = fill[fill[:, 0].argsort()]
    assert int(fill[0, 0]) == 0 and int(fill[-1, 1]) == m_local
    assert torch.equal(fill[1:, 0], fill[:-1, 1])
    body = fill[fill[:, 0] < m_local // 4 * 4]
    assert bool((body % 4 == 0).all())
    assert bool((s["hits"] == 1).all()) and bool((s["columns"] == 1).all())
    rounds = s["rounds"].view(grid, WARPS_PER_BLOCK)
    assert int(rounds.max()) <= STAGE_ROUNDS and int(rounds[:, 0].max()) == 0
    n_staged = int(s["staged"].sum())
    if -(-tile // 32) > STAGE_ROUNDS:
        assert n_staged == 0
    else:
        assert 0 < n_staged < rows * L * -(-d // tile) or rows < grid
    assert not bool(s["staged"].view(-1)[s["n_own"]:].any())
    assert s["empty"] == grid * WARPS_PER_BLOCK
