"""The port's SparseGrad builders and its sparse-gradient capture against the
JAX reference (``repro.optim.sparse``) on the CPU.

- ``dedup_locations`` and ``from_bucketed_locations`` on the same inputs:
  indices exact, values exact (the same stable sort, the same left-to-right
  segment sums).
- The capture's SparseGrad against ``sparse_value_and_grad``'s for lma
  (striped, so bucketed), hashed_elem (flat dedup) and hashed_row (row
  mode: one index per pool row, [K, d] values, dense_shape (m // d, d)):
  indices exact, values within 1e-7 absolute (the gradients themselves come
  from two autograd engines, which may round the loss's mean and product
  differently), and the pool's ``.grad`` stays None.
- Row mode's edges: hashed_row's row ids bit-exact (ids and seeds >= 2^31),
  a ragged budget falls back to element-level records as the reference's
  does, and one pool with row and element records is an error.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.signatures import synthetic_dense_store  # noqa: E402
from repro.embed import EmbeddingTable as JTable  # noqa: E402
from repro.embed import get_scheme as jscheme  # noqa: E402
from repro.optim import sparse as jsp  # noqa: E402
from repro_torch.convert import buffers_from_numpy  # noqa: E402
from repro_torch.embed import EmbeddingTable as TTable  # noqa: E402
from repro_torch.embed import get_scheme as tscheme  # noqa: E402
from repro_torch.optim import sparse as tsp  # noqa: E402


def _striped_loc(rng, n, d, stripe):
    """[n, d] locations, column j in stripe j, heavy duplicates."""
    off = rng.integers(0, max(stripe // 8, 1), (n, d))
    return (np.arange(d)[None, :] * stripe + off).astype(np.int32)


def test_dedup_locations_matches_reference():
    rng = np.random.default_rng(0)
    loc = rng.integers(0, 300, 5000).astype(np.int32)
    vals = rng.normal(0, 1, 5000).astype(np.float32)
    j = jsp.dedup_locations(jnp.asarray(loc), jnp.asarray(vals), (512,))
    t = tsp.dedup_locations(torch.from_numpy(loc), torch.from_numpy(vals),
                            (512,))
    assert t.unique and t.dense_shape == (512,)
    assert np.array_equal(np.asarray(j.indices), t.indices.numpy())
    assert np.array_equal(np.asarray(j.values), t.values.numpy())
    assert np.array_equal(np.asarray(j.densify()), t.densify().numpy())


@pytest.mark.parametrize("n,d,m", [(700, 8, 4096), (1, 4, 64), (333, 16, 8192)])
def test_from_bucketed_locations_matches_reference(n, d, m):
    rng = np.random.default_rng(n)
    loc = _striped_loc(rng, n, d, m // d)
    vals = rng.normal(0, 1, (n, d)).astype(np.float32)
    j = jsp.from_bucketed_locations(jnp.asarray(loc), jnp.asarray(vals), (m,))
    t = tsp.from_bucketed_locations(torch.from_numpy(loc),
                                    torch.from_numpy(vals), (m,))
    assert (t.unique, t.buckets) == (j.unique, j.buckets) == (False, d)
    assert np.array_equal(np.asarray(j.indices), t.indices.numpy())
    assert np.array_equal(np.asarray(j.values), t.values.numpy())


def test_ragged_budget_falls_back_to_flat_dedup():
    rng = np.random.default_rng(1)
    loc = rng.integers(0, 66, (40, 4)).astype(np.int32)
    vals = rng.normal(0, 1, (40, 4)).astype(np.float32)
    j = jsp.from_bucketed_locations(jnp.asarray(loc), jnp.asarray(vals), (66,))
    t = tsp.from_bucketed_locations(torch.from_numpy(loc),
                                    torch.from_numpy(vals), (66,))
    assert t.unique and j.unique
    assert np.array_equal(np.asarray(j.indices), t.indices.numpy())
    assert np.array_equal(np.asarray(j.values), t.values.numpy())


def _setup(kind):
    jt = JTable(jscheme(kind).build_config((512, 256), 8, 4096, seed=3))
    tt = TTable(tscheme(kind).build_config((512, 256), 8, 4096, seed=3))
    jbufs = {}
    if kind == "lma":
        jbufs = jt.make_buffers(synthetic_dense_store(
            jt.config.total_vocab, 8, max_set=32, seed=2))
    tbufs = buffers_from_numpy({k: np.asarray(v) for k, v in jbufs.items()},
                               device="cpu")
    jp = {"embedding": jt.init(jax.random.key(1))}
    mem = torch.from_numpy(np.array(jp["embedding"]["memory"]))
    return jt, jbufs, jp, tt, tbufs, torch.nn.Parameter(mem)


@pytest.mark.parametrize("kind,bucketed", [("lma", True),
                                           ("hashed_elem", False),
                                           ("hashed_row", False)])
def test_capture_matches_sparse_value_and_grad(kind, bucketed):
    jt, jbufs, jp, tt, tbufs, mem = _setup(kind)
    rng = np.random.default_rng(7)
    ids = (rng.integers(0, 512, (48, 2)) % np.array([512, 256])).astype(
        np.int32)
    ids2 = rng.integers(0, 256, (20,)).astype(np.int32)
    y = rng.normal(size=(48,)).astype(np.float32)
    w = np.linspace(-1, 1, 8, dtype=np.float32)

    def jloss(p, _):
        e = jt.embed_fields(p["embedding"], jbufs, jnp.asarray(ids))
        e2 = jt.embed(p["embedding"], jbufs, 1, jnp.asarray(ids2))
        pred = jnp.einsum("bfd,d->b", e, jnp.asarray(w))
        loss = jnp.mean((pred - jnp.asarray(y)) ** 2) + jnp.mean(e2 ** 2)
        return loss, {}

    (jl, _), jg = jsp.sparse_value_and_grad(jloss)(jp, None)
    jsg = jg["embedding"]["memory"]
    with tsp.capture() as cap:
        e = tt.embed_fields({"memory": mem}, tbufs, torch.from_numpy(ids))
        e2 = tt.embed({"memory": mem}, tbufs, 1, torch.from_numpy(ids2))
        pred = torch.einsum("bfd,d->b", e, torch.from_numpy(w))
        loss = torch.mean((pred - torch.from_numpy(y)) ** 2) \
            + torch.mean(e2 ** 2)
        loss.backward()
    assert mem.grad is None
    tsg = cap.grads({"embedding.memory": mem})["embedding.memory"]
    assert not cap.records
    assert (tsg.unique, tsg.buckets) == (jsg.unique, jsg.buckets)
    assert tsg.dense_shape == jsg.dense_shape
    assert tsg.unique is not bucketed
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    assert np.array_equal(np.asarray(jsg.indices), tsg.indices.numpy())
    np.testing.assert_allclose(tsg.values.numpy(), np.asarray(jsg.values),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(tsg.densify().numpy(),
                               np.asarray(jsg.densify()), rtol=0, atol=1e-7)


def test_no_capture_gives_a_dense_pool_gradient():
    _, _, _, tt, tbufs, mem = _setup("hashed_elem")
    out = tt.embed({"memory": mem}, tbufs, 0, torch.arange(10))
    out.sum().backward()
    assert mem.grad is not None and mem.grad.shape == (4096,)
    assert tsp.active() is None


def test_sparse_row_ids_bit_exact():
    """hashed_row's row index, ids and seeds >= 2^31 included, and the
    element locations it implies."""
    rng = np.random.default_rng(4)
    gids = rng.integers(0, 2**32, 3000, dtype=np.uint64).astype(np.uint32)
    gids[:5] = (0, 1, 2**31, 2**32 - 1, 2**31 - 1)
    for seed in (0, 0x9000_0001, 2**32 - 7):
        jt = jscheme("hashed_row")
        cfg = jt.build_config((1000,), 64, 135_053_312, seed=seed)
        want = np.asarray(jt.sparse_row_ids(cfg, {}, jnp.asarray(gids)))
        tcfg = tscheme("hashed_row").build_config((1000,), 64, 135_053_312,
                                                  seed=seed)
        tg = torch.from_numpy(gids.view(np.int32))
        got = tscheme("hashed_row").sparse_row_ids(tcfg, {}, tg)
        assert got.dtype == torch.int32
        assert np.array_equal(want, got.numpy())
        loc = tscheme("hashed_row").locations(tcfg, {}, tg)
        assert torch.equal(loc, got[:, None] * 64 + torch.arange(64))
    assert tscheme("lma").sparse_row_ids(None, {}, tg) is None


def test_ragged_budget_falls_back_to_element_mode():
    """m % d != 0 cannot tile into rows: hashed_row records element-level
    locations, as the reference's test of the same name demands."""
    jt = JTable(jscheme("hashed_row").build_config((128,), 4, 66, seed=1))
    tt = TTable(tscheme("hashed_row").build_config((128,), 4, 66, seed=1))
    jp = {"embedding": jt.init(jax.random.key(0))}
    mem = torch.nn.Parameter(torch.from_numpy(
        np.array(jp["embedding"]["memory"])))
    ids = np.arange(8, dtype=np.int32)

    def jloss(p, _):
        return jnp.mean(jt.embed(p["embedding"], {}, 0,
                                 jnp.asarray(ids)) ** 2), {}

    (_, _), jg = jsp.sparse_value_and_grad(jloss)(jp, None)
    jsg = jg["embedding"]["memory"]
    with tsp.capture() as cap:
        torch.mean(tt.embed({"memory": mem}, {}, 0,
                            torch.from_numpy(ids)) ** 2).backward()
    tsg = cap.grads({"memory": mem})["memory"]
    assert tsg.dense_shape == jsg.dense_shape == (66,)
    assert tsg.values.dim() == 1 and tsg.unique
    assert np.array_equal(np.asarray(jsg.indices), tsg.indices.numpy())
    np.testing.assert_allclose(tsg.values.numpy(), np.asarray(jsg.values),
                               rtol=0, atol=1e-7)


def test_one_pool_mixing_row_and_element_records_raises():
    mem = torch.nn.Parameter(torch.zeros(64))
    with tsp.capture() as cap:
        a = cap.lookup(mem, lambda: mem[:8].reshape(2, 4),
                       lambda: torch.tensor([0, 3], dtype=torch.int32),
                       row_width=4)
        b = cap.lookup(mem, lambda: mem[8:16].reshape(2, 4),
                       lambda: torch.arange(8, dtype=torch.int32).reshape(2,
                                                                          4))
        (a.sum() + b.sum()).backward()
    with pytest.raises(ValueError, match="mixes row- and element-level"):
        cap.grads({"memory": mem})
