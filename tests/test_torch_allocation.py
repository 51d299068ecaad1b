"""Port allocators, signature builders and pool vs the JAX reference.

Every location is bit-identical: flat and striped, independent and sliding
windows, very-sparse fallback rows present, keys and seeds >= 2^31.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import allocation as ja  # noqa: E402
from repro.core import memory as jmem  # noqa: E402
from repro.core import signatures as js  # noqa: E402
from repro_torch.core import allocation as ta  # noqa: E402
from repro_torch.core import memory as tmem  # noqa: E402
from repro_torch.core import signatures as ts  # noqa: E402

D, M = 16, 8192


def _ids(n=97, seed=0, high=True):
    rng = np.random.default_rng(seed)
    lo = 2**31 - 10_000 if high else 0
    return rng.integers(lo, 2**31 - 1, n).astype(np.int32)


def _rows(n, s, seed=0):
    """uint32 sets with keys >= 2^31, PAD tails, an empty row."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, (n, s), dtype=np.uint64).astype(np.uint32)
    x[:, 0] |= np.uint32(1 << 31)
    lens = rng.integers(0, s + 1, n)
    x[np.arange(s)[None, :] >= lens[:, None]] = 0xFFFFFFFF
    x[0] = 0xFFFFFFFF
    return x, lens.astype(np.int32)


def _t(x):
    x = np.asarray(x)
    return torch.from_numpy((x.view(np.int32) if x.dtype == np.uint32
                             else x).copy())


def test_alloc_full_bit_identical():
    ids = _ids(high=False) % 1000
    np.testing.assert_array_equal(
        ta.alloc_full(_t(ids), D).numpy(),
        np.asarray(ja.alloc_full(jnp.asarray(ids), D)))


@pytest.mark.parametrize("stripe", [0, M // D])
@pytest.mark.parametrize("seed", [3, 0x80000001])
def test_alloc_hashed_elem_bit_identical(stripe, seed):
    ids = _ids(seed=seed % 7)
    np.testing.assert_array_equal(
        ta.alloc_hashed_elem(_t(ids), D, M, seed, stripe=stripe).numpy(),
        np.asarray(ja.alloc_hashed_elem(jnp.asarray(ids), D, M, seed,
                                        stripe=stripe)))


@pytest.mark.parametrize("m", [M, M + 7])
def test_alloc_hashed_row_bit_identical(m):
    ids = _ids(seed=1)
    np.testing.assert_array_equal(
        ta.alloc_hashed_row(_t(ids), D, m, 0xC0FFEE01).numpy(),
        np.asarray(ja.alloc_hashed_row(jnp.asarray(ids), D, m, 0xC0FFEE01)))


def _params(independent, striped, seed=0x9000_0013, m=M, **kw):
    kw = dict(d=D, m=m, n_h=3, max_set=12, seed=seed,
              independent_hashes=independent, striped=striped,
              min_support=2, **kw)
    return ja.LMAParams(**kw), ta.LMAParams(**kw)


@pytest.mark.parametrize("independent", [True, False])
@pytest.mark.parametrize("striped", [False, True])
@pytest.mark.parametrize("seed", [0x5C3A, 0xF000_0001])
def test_alloc_lma_from_rows_bit_identical(independent, striped, seed):
    jp, tp = _params(independent, striped, seed)
    assert tp.stripe == jp.stripe and tp.n_raw_hashes == jp.n_raw_hashes
    rows, support = _rows(120, 20, seed=seed % 11)   # wider than max_set
    assert (support < tp.min_support).any()          # fallback rows present
    ids = _ids(120, seed=5)
    got = ta.alloc_lma_from_rows(tp, _t(rows), _t(support), _t(ids))
    want = ja.alloc_lma_from_rows(jp, jnp.asarray(rows), jnp.asarray(support),
                                  jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("independent", [True, False])
def test_locations_from_signatures_bit_identical(independent):
    jp, tp = _params(independent, striped=False, m=M + 13)
    rng = np.random.default_rng(4)
    sigs = rng.integers(0, 2**32, (50, tp.n_raw_hashes),
                        dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        ta.locations_from_signatures(tp, _t(sigs)).numpy(),
        np.asarray(ja.locations_from_signatures(jp, jnp.asarray(sigs))))


@pytest.mark.parametrize("striped", [False, True])
def test_alloc_lma_dense_store_bit_identical(striped):
    jp, tp = _params(True, striped)
    csr = js.synthetic_signature_store(200, 7, samples_per_value=3, seed=2)
    jstore = js.densify_store(csr, 12)
    jstore = dataclasses.replace(
        jstore, lengths=jstore.lengths.at[::5].set(1))   # very sparse rows
    tstore = ts.DenseSignatureStore(_t(np.asarray(jstore.sets)),
                                    _t(np.asarray(jstore.lengths)))
    ids = np.random.default_rng(0).integers(0, 200, 150).astype(np.int32)
    np.testing.assert_array_equal(
        ta.alloc_lma(tp, tstore, _t(ids)).numpy(),
        np.asarray(ja.alloc_lma(jp, jstore, jnp.asarray(ids))))


def test_signature_builders_match_reference():
    for args in [(300, 7, 16, 0.9, 3), (50, 4, 8, 0.5, 0)]:
        j = js.synthetic_dense_store(*args)
        t = ts.synthetic_dense_store(*args, device="cpu")
        np.testing.assert_array_equal(t.sets.numpy().view(np.uint32),
                                      np.asarray(j.sets))
        np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
    jc = js.synthetic_signature_store(40, 3, samples_per_value=5, seed=1)
    jd = js.densify_store(jc, 4, n_rows=48)
    td = ts.densify_store(jc, 4, n_rows=48, device="cpu")
    np.testing.assert_array_equal(td.sets.numpy().view(np.uint32),
                                  np.asarray(jd.sets))
    np.testing.assert_array_equal(td.lengths.numpy(), np.asarray(jd.lengths))
    assert ts.DenseSignatureStore.PAD == int(js.DenseSignatureStore.PAD)


def test_planted_dense_store_structure():
    store = ts.planted_dense_store(1000, 16, max_set=8, seed=3, device="cpu",
                                   chunk=300)
    sets = store.sets.numpy().view(np.uint32)
    assert sets.shape == (1000, 8) and (store.lengths.numpy() == 8).all()
    cluster = np.arange(1000) % 16
    np.testing.assert_array_equal(sets >> 16, np.repeat(cluster[:, None], 8, 1))
    picks = sets & 0xFFFF
    assert (picks < 8).all()          # pool of max(8, int(8 / 0.9)) = 8
    assert all(len(set(r)) == 8 for r in picks)   # distinct within a row


def test_lookup_and_init_memory():
    mem = np.random.default_rng(0).normal(size=M).astype(np.float32)
    loc = np.random.default_rng(1).integers(0, M, (30, D)).astype(np.int32)
    np.testing.assert_array_equal(
        tmem.lookup(torch.from_numpy(mem), torch.from_numpy(loc)).numpy(),
        np.asarray(jmem.lookup(jnp.asarray(mem), jnp.asarray(loc))))
    b = tmem.init_memory(4096, "bernoulli", 0.5, device="cpu")
    assert set(np.unique(b.numpy())) == {-0.5, 0.5}
    u = tmem.init_memory(4096, "uniform", 2.0, device="cpu")
    assert u.abs().max() <= 2.0
    n = tmem.init_memory(4096, "normal", 0.1, device="cpu")
    assert abs(float(n.std()) - 0.1) < 0.01
    with pytest.raises(ValueError):
        tmem.init_memory(8, "bogus", device="cpu")
