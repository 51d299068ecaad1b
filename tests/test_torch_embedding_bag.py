"""The port's embedding bag (``repro_torch.kernels.embedding_bag``, plain
version on the CPU) against the reference's public op (its Pallas kernel in
interpret mode) and its jnp ``embedding_bag_ref``, float32: every output
within 1e-6 of its ``sum_l |w T|`` (the reference sums the one-hot matmul's
tiles, the port gathers and sums in another order).  Shapes include B off
the reference's 128-row block, L past a warp, and a bag of zero weights."""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from kernel_schedules import bag_fma_chain, fmaf  # noqa: E402
from repro.kernels.embedding_bag.ops import embedding_bag as jbag  # noqa: E402
from repro.kernels.embedding_bag.ref import embedding_bag_ref as jref  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as tops  # noqa: E402
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref  # noqa: E402


def _case(V, d, B, L, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, d)).astype(np.float32)
    ids = rng.integers(0, V, (B, L), dtype=np.int32)
    w = (rng.random((B, L)) - 0.3).astype(np.float32)
    w[0] = 0.0                                        # an empty bag
    return table, ids, w


@pytest.mark.parametrize("V,d,B,L", [(512, 16, 32, 8), (1024, 64, 128, 20),
                                     (4096, 64, 200, 4), (384, 8, 96, 100),
                                     (1000, 10, 333, 26)])
def test_embedding_bag_matches_reference(V, d, B, L):
    table, ids, w = _case(V, d, B, L, V + B)
    got = tops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                             torch.from_numpy(w)).numpy()
    scale = np.einsum("bl,bld->bd", np.abs(w).astype(np.float64),
                      np.abs(table[ids]).astype(np.float64))
    for want in (jbag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(w),
                      True),
                 jref(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(w))):
        err = np.abs(got - np.asarray(want)) / np.maximum(scale, 1e-30)
        assert got.shape == (B, d) and float(err.max()) <= 1e-6
    assert not got[0].any()


def test_embedding_bag_is_the_plain_version_on_the_cpu():
    table, ids, w = _case(64, 8, 5, 3, 1)
    args = tuple(map(torch.from_numpy, (table, ids, w)))
    assert torch.equal(tops.embedding_bag(*args), embedding_bag_ref(*args))
    with pytest.raises(ValueError, match="unsupported device"):
        tops.embedding_bag(torch.zeros((4, 2), device="meta"), None, None)


# ----------------------------- the kernel's order of sums, emulated
#
# ``kernel_schedules.bag_fma_chain`` is csrc/embedding_bag.cu's order: each
# column an fmaf chain in l order, an id outside [0, V) skipped.  The card
# tests hold the kernel to its bits; here it is held to the reference.

def _exact_f32(x: Fraction) -> np.float32:
    """x rounded once to float32, to nearest, ties to even."""
    r = np.float32(float(x))
    cands = [r, np.nextafter(r, np.float32(np.inf)),
             np.nextafter(r, np.float32(-np.inf))]
    dist = [abs(Fraction(float(c)) - x) for c in cands]
    best = min(dist)
    ties = [c for c, e in zip(cands, dist) if e == best]
    return min(ties, key=lambda c: int(np.float32(c).view(np.int32)) & 1)


def test_fmaf_rounds_once():
    """``fmaf`` against a * b + c taken exactly (fractions) and rounded
    once, on random operands of many scales and on sums that float64 rounds
    onto a float32 midpoint (where rounding twice would be off by an ulp)."""
    rng = np.random.default_rng(0)
    n = 3000
    a = (rng.normal(0, 1, n) * 10.0 ** rng.uniform(-5, 5, n)).astype(
        np.float32)
    b = (rng.normal(0, 1, n) * 10.0 ** rng.uniform(-5, 5, n)).astype(
        np.float32)
    c = (rng.normal(0, 1, n) * 10.0 ** rng.uniform(-10, 10, n)).astype(
        np.float32)
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24, a float32 midpoint; +-2^-60 moves it
    # off the midpoint by less than float64 keeps
    t = np.float32(1 + 2.0 ** -12)
    a = np.concatenate([a, [t, t, t, -t]]).astype(np.float32)
    b = np.concatenate([b, [t, t, t, t]]).astype(np.float32)
    c = np.concatenate([c, [2.0 ** -60, -2.0 ** -60, 0.0, 2.0 ** -60]]
                       ).astype(np.float32)
    got = fmaf(*map(torch.from_numpy, (a, b, c))).numpy()
    want = np.array([_exact_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    assert got[-4] == np.float32(1 + 2.0 ** -11 + 2.0 ** -23)
    assert got[-3] == got[-2] == np.float32(1 + 2.0 ** -11)


@pytest.mark.parametrize("V,d,B,L", [(512, 16, 32, 8), (1000, 10, 33, 26),
                                     (384, 100, 9, 33), (64, 64, 7, 1)])
def test_bag_fma_chain_matches_reference(V, d, B, L):
    """The kernel's order of sums within 1e-6 of each output's sum_l |w T|
    of the reference's jnp version, and within it of the port's plain
    version; ids outside [0, V) (which the kernel skips) add nothing."""
    table, ids, w = _case(V, d, B, L, V + L)
    bad = ids.copy()
    bad[1, 0], bad[2, -1] = -1, V           # two ids outside [0, V)
    got = bag_fma_chain(*map(torch.from_numpy, (table, bad, w))).numpy()
    keep = (bad >= 0) & (bad < V)
    w_kept = np.where(keep, w, 0.0).astype(np.float32)
    want = np.asarray(jref(jnp.asarray(table), jnp.asarray(ids),
                           jnp.asarray(w_kept)))
    plain = embedding_bag_ref(*map(torch.from_numpy,
                                   (table, ids, w_kept))).numpy()
    scale = np.einsum("bl,bld->bd", np.abs(w_kept).astype(np.float64),
                      np.abs(table[ids]).astype(np.float64))
    for other in (want, plain):
        err = np.abs(got - other) / np.maximum(scale, 1e-30)
        assert float(err.max()) <= 1e-6
    assert not got[0].any()
