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
    with pytest.raises(NotImplementedError):
        tops.sparse_update("adam", torch.zeros(1, dtype=torch.int32),
                           torch.zeros(1), (torch.zeros(4), torch.zeros(4)),
                           lr=0.1)
