"""Port hash core vs the JAX reference: bit-identical, keys and seeds >= 2^31."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import hashing as jh  # noqa: E402
from repro.core import minhash as jm  # noqa: E402
from repro_torch.core import hashing as th  # noqa: E402
from repro_torch.core import minhash as tm  # noqa: E402

SEEDS = [0, 0x5C3A, 0x7FFFFFFF, 0x80000000, 0xDEADBEEF, 0xFFFFFFFF]


def _keys(n=257, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF]
    return x


def _t(x: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> the port's int32 bit-pattern tensor."""
    return torch.from_numpy(x.view(np.int32).copy())


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_fmix32_bit_identical():
    x = _keys()
    np.testing.assert_array_equal(_u32(th.fmix32(_t(x))),
                                  np.asarray(jh.fmix32(jnp.asarray(x))))


@pytest.mark.parametrize("seed", SEEDS)
def test_seed_stream_bit_identical(seed):
    np.testing.assert_array_equal(_u32(th.seed_stream(seed, 300, "cpu")),
                                  np.asarray(jh.seed_stream(seed, 300)))


@pytest.mark.parametrize("seed", SEEDS)
def test_hash_u32_and_pair_bit_identical(seed):
    x, y = _keys(seed=1), _keys(seed=2)
    s = np.uint32(seed)
    np.testing.assert_array_equal(
        _u32(th.hash_u32(_t(x), seed)),
        np.asarray(jh.hash_u32(jnp.asarray(x), jnp.uint32(s))))
    np.testing.assert_array_equal(
        _u32(th.hash_pair(_t(x), _t(y), seed)),
        np.asarray(jh.hash_pair(jnp.asarray(x), jnp.asarray(y),
                                jnp.uint32(s))))
    # a per-element seed tensor broadcasts like the reference
    seeds = _keys(seed=3)
    np.testing.assert_array_equal(
        _u32(th.hash_u32(_t(x), _t(seeds))),
        np.asarray(jh.hash_u32(jnp.asarray(x), jnp.asarray(seeds))))


@pytest.mark.parametrize("k", [1, 3, 4])
def test_combine_chain_bit_identical(k):
    parts = _keys(64 * k, seed=k).reshape(16, 4, k)
    seed = _keys(4, seed=9)
    got = th.combine_chain(_t(parts), _t(seed)[None, :], axis=-1)
    want = jh.combine_chain(jnp.asarray(parts), jnp.asarray(seed)[None, :],
                            axis=-1)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))


@pytest.mark.parametrize("n_hashes,chunk", [(16, 16), (37, 16), (64, 8)])
def test_minhash_dense_bit_identical(n_hashes, chunk):
    rng = np.random.default_rng(n_hashes)
    elems = _keys(40 * 12, seed=n_hashes).reshape(40, 12)
    mask = rng.random((40, 12)) < 0.7
    mask[0] = False                          # empty set -> UINT32_MAX
    seed = 0x9ABCDEF1
    got = tm.minhash_dense(_t(elems), torch.from_numpy(mask), n_hashes, seed,
                           chunk=chunk)
    want = jm.minhash_dense(jnp.asarray(elems), jnp.asarray(mask), n_hashes,
                            seed)
    np.testing.assert_array_equal(_u32(got), np.asarray(want))
    assert (_u32(got)[0] == 0xFFFFFFFF).all()
