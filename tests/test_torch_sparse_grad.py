"""The port's SparseGrad builders and its sparse-gradient capture against the
JAX reference (``repro.optim.sparse``) on the CPU.

- ``dedup_locations`` and ``from_bucketed_locations`` on the same inputs:
  indices exact, values exact (the same stable sort, the same left-to-right
  segment sums).
- The capture's SparseGrad against ``sparse_value_and_grad``'s for lma
  (striped, so bucketed) and hashed_elem (flat dedup): indices exact, values
  within 1e-7 absolute (the gradients themselves come from two autograd
  engines, which may round the loss's mean and product differently), and
  the pool's ``.grad`` stays None.
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
                                           ("hashed_elem", False)])
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
