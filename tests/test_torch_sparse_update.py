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
