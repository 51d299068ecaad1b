"""The chunked exchange's plain versions (rows 10-12) and the slab mode of
the plain lookup and scatter-add, against the reference's Pallas kernels in
interpret mode, on one rank's slab of a 4-way split with ``block_m`` below
the slab so that the reference tiles it: partials and locations
bit-identical, scatters within 1e-6 of each slot's sum |g|."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.allocation import LMAParams as JParams  # noqa: E402
from repro.core.signatures import synthetic_dense_store  # noqa: E402
from repro.kernels.fused_embed import kernel as jk  # noqa: E402
from repro.kernels.fused_embed import ops as jfe  # noqa: E402
from repro_torch.core.allocation import LMAParams  # noqa: E402
from repro_torch.kernels.fused_embed import ops as fe  # noqa: E402
from repro_torch.kernels.fused_embed import ref as fref  # noqa: E402

N_VALUES, D, M, P = 512, 16, 8192, 4
M_LOCAL = M // P
BLOCK_B, BLOCK_M = 8, M_LOCAL // 4
SUM_RTOL = 1e-6


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy((x.view(np.int32) if x.dtype == np.uint32
                             else x).copy())


def _case(scheme, rank, seed=0, B=64):
    """(torch spec, jax spec, mem slab, gids, sets, support, base) for
    ``scheme`` on ``rank``'s slab; lma has fallback rows."""
    rng = np.random.default_rng(seed + 10 * rank)
    mem = rng.normal(0, 0.1, M).astype(np.float32)
    base = rank * M_LOCAL
    if scheme.startswith("lma"):
        striped = scheme == "lma_striped"
        kw = dict(d=D, m=M, n_h=4, max_set=16, seed=0x8000_0007,
                  striped=striped)
        store = synthetic_dense_store(N_VALUES, 8, max_set=16, seed=1)
        sets = np.asarray(store.sets)
        support = np.asarray(store.lengths).copy()
        support[::7] = rng.integers(0, 2, len(support[::7]))
        gids = rng.integers(0, N_VALUES, B).astype(np.int32)
        gids[0] = 0
        tspec, jspec = fe.lma_spec(LMAParams(**kw)), jfe.lma_spec(JParams(**kw))
        return (tspec, jspec, mem[base:base + M_LOCAL], gids, sets[gids],
                support[gids], base)
    gids = rng.integers(0, 2**31 - 1, B).astype(np.int32)
    return (fe.hashed_spec(scheme, D, M, 0xFEED_0001),
            jfe.hashed_spec(scheme, D, M, 0xFEED_0001),
            mem[base:base + M_LOCAL], gids, None, None, base)


def _jax_loc_inputs(jspec, gids, sets, support):
    if sets is None:
        sets = np.zeros(gids.shape + (1,), np.uint32)
        support = np.zeros(gids.shape, np.int32)
    return jfe._loc_inputs(jspec, jnp.asarray(sets), jnp.asarray(gids),
                           jnp.asarray(support))


def _kw(jspec):
    return jfe._kern_kwargs(jspec, True, BLOCK_B)


def _extra(sets, support):
    return () if sets is None else (_t(sets), _t(support))


SCHEMES = ["lma_flat", "lma_striped", "hashed_elem", "hashed_row"]


@pytest.mark.parametrize("rank", [0, 2])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_chunk_lookup_bit_identical(scheme, rank):
    tspec, jspec, mem, gids, sets, support, base = _case(scheme, rank)
    part, loc = fe.fused_chunk_lookup(tspec, _t(mem), _t(gids),
                                      *_extra(sets, support), base=base)
    jpart, jloc = jk.fused_chunk_fwd_pallas(
        jspec.scheme, jnp.asarray(mem),
        _jax_loc_inputs(jspec, gids, sets, support),
        jnp.asarray([base], jnp.int32), block_m=BLOCK_M, **_kw(jspec))
    np.testing.assert_array_equal(loc.numpy(), np.asarray(jloc))
    np.testing.assert_array_equal(part.numpy(), np.asarray(jpart))
    inb = (loc >= base) & (loc < base + M_LOCAL)
    assert inb.any() and (~inb).any()          # both sides of the mask


# A rank's few-row chunk: which of _case's values (value 0 is a fallback
# one under lma)
FEW_ROWS = {"fallback": [0], "minhash": [1], "three": [0, 1, 2]}


@pytest.mark.parametrize("rows", sorted(FEW_ROWS))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_few_row_chunk_lookup_bit_identical(scheme, rows):
    """Row 10 at a rank's few-row chunk (1 and 3 rows, the lma fallback row
    alone, a minhash row alone, and both together) on each of the four
    slabs: partials and locations bit-identical to the reference's kernel
    in interpret mode, which pads the chunk to its block of rows; over the
    four slabs both sides of the mask occur (base > 0 on three)."""
    tspec, jspec, _, gids, sets, support, _ = _case(scheme, 0, 4, B=8)
    pick = np.asarray(FEW_ROWS[rows])
    gids = gids[pick]
    if sets is not None:
        sets, support = sets[pick], support[pick]
        fb = support < tspec.min_support
        assert list(fb) == [r == 0 for r in FEW_ROWS[rows]]
    mem = np.random.default_rng(5).normal(0, 0.1, M).astype(np.float32)
    sides = set()
    for rank in range(P):
        base = rank * M_LOCAL
        slab = mem[base:base + M_LOCAL]
        part, loc = fref.chunk_lookup_ref(tspec, _t(slab), _t(gids),
                                          *_extra(sets, support), base=base)
        jpart, jloc = jk.fused_chunk_fwd_pallas(
            jspec.scheme, jnp.asarray(slab),
            _jax_loc_inputs(jspec, gids, sets, support),
            jnp.asarray([base], jnp.int32), block_m=BLOCK_M, **_kw(jspec))
        np.testing.assert_array_equal(loc.numpy(), np.asarray(jloc))
        np.testing.assert_array_equal(part.numpy(), np.asarray(jpart))
        inb = ((loc >= base) & (loc < base + M_LOCAL)).numpy()
        sides.update(inb.ravel().tolist())
        assert (part.numpy()[~inb] == 0).all()
    assert sides == {True, False}


@pytest.mark.parametrize("rank", [1, 3])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_chunk_gather_and_scatter_match(scheme, rank):
    tspec, jspec, mem, gids, sets, support, base = _case(scheme, rank, 1)
    loc = fref.locations_ref(tspec, _t(gids), *_extra(sets, support))
    got = fe.fused_chunk_gather(_t(mem), loc, base)
    want = jk.fused_chunk_gather_pallas(
        jnp.asarray(mem), jnp.asarray(loc.numpy()),
        jnp.asarray([base], jnp.int32), block_b=BLOCK_B, block_m=BLOCK_M,
        interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = np.random.default_rng(rank).normal(0, 1, loc.shape).astype(np.float32)
    dm = fe.fused_chunk_scatter(loc, _t(g), base, M_LOCAL)
    jdm = jk.fused_chunk_scatter_pallas(
        jnp.asarray(loc.numpy()), jnp.asarray(g),
        jnp.asarray([base], jnp.int32), M_LOCAL, jnp.float32,
        block_b=BLOCK_B, block_m=BLOCK_M, interpret=True)
    _within_sum_abs(dm.numpy(), np.asarray(jdm), loc.numpy() - base, g)


def _within_sum_abs(got, want, rel, g):
    """Per slot within SUM_RTOL of its sum |g| (the in-slab entries)."""
    inb = (rel >= 0) & (rel < got.shape[0])
    abs_sum = np.zeros(got.shape[0], np.float64)
    np.add.at(abs_sum, rel[inb], np.abs(g[inb]).astype(np.float64))
    assert np.all(np.abs(got.astype(np.float64) - want) <= SUM_RTOL * abs_sum)
    assert np.all(got[abs_sum == 0] == 0)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_chunk_ops_backward_scatters_by_locations(scheme):
    """The autograd form: a chunk lookup's and a chunk gather's slab
    gradient is the chunk scatter of the cotangent by the locations."""
    tspec, _, mem, gids, sets, support, base = _case(scheme, 1, 2)
    memt = _t(mem).requires_grad_()
    part, loc = fe.fused_chunk_lookup(tspec, memt, _t(gids),
                                      *_extra(sets, support), base=base)
    g = torch.randn(part.shape, generator=torch.Generator().manual_seed(0))
    part.backward(g)
    assert torch.equal(memt.grad, fref.chunk_scatter_ref(loc, g, base,
                                                         M_LOCAL))
    memt.grad = None
    fe.fused_chunk_gather(memt, loc, base).backward(g)
    assert torch.equal(memt.grad, fref.chunk_scatter_ref(loc, g, base,
                                                         M_LOCAL))


@pytest.mark.parametrize("rank", [0, 3])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_slab_mode_lookup_and_scatter_add(scheme, rank):
    """Rows 2 and 5 in slab mode (``base``) against fused_lookup_fwd_pallas
    and fused_scatter_add_pallas with the same base."""
    tspec, jspec, mem, gids, sets, support, base = _case(scheme, rank, 3)
    extra = _extra(sets, support)
    got = fe.fused_lookup(tspec, _t(mem), _t(gids), *extra, base=base)
    jbase = jnp.asarray([base], jnp.int32)
    loc_inputs = _jax_loc_inputs(jspec, gids, sets, support)
    want = jk.fused_lookup_fwd_pallas(jspec.scheme, jnp.asarray(mem),
                                      loc_inputs, jbase, **_kw(jspec))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = np.random.default_rng(rank).normal(0, 1, got.shape).astype(np.float32)
    dm = fe.fused_scatter_add(tspec, _t(g), _t(gids), *extra, base=base,
                              m_local=M_LOCAL)
    jdm = jk.fused_scatter_add_pallas(jspec.scheme, jnp.asarray(g),
                                      loc_inputs, jbase, M_LOCAL,
                                      jnp.float32, **_kw(jspec))
    loc = fref.locations_ref(tspec, _t(gids), *extra).numpy()
    _within_sum_abs(dm.numpy(), np.asarray(jdm), loc - base, g)
    # the slab's gradient is the whole pool's gradient restricted to it
    whole = fref.scatter_add_ref(tspec, _t(g), _t(gids), *extra)
    torch.testing.assert_close(dm, whole[base:base + M_LOCAL], rtol=0,
                               atol=0)
