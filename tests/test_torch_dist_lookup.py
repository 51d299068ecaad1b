"""Sharded lookups of the port on gloo ranks (CPU), against the reference's
single-device ``EmbeddingTable.embed_fields`` on the same numpy parameters.

One spawn of 4 ranks (and one of 2) runs every case
(``dist_ranks.lookups``): lma (striped and flat, with fallback rows),
hashed_elem and hashed_row, under psum, ring and all_to_all, pinned through
``REPRO_DIST_EXCHANGE``'s ``FORCED``.  The sharded paths are the kernel
paths, their plain versions running on the CPU.

- Every rank's output bit-identical to the reference's lookup.
- Every rank's slab gradient of ``sum(out * g)`` (the chunk scatter, or
  psum's slab scatter-add) within 1e-6 of the reference's ``jax.grad``,
  restricted to the slab.
- ``sharded_set_lookup`` exact for the store's sets and lengths, and the
  sets through ``Exchange.partial_sum_lookup`` (the general set gather).
- The pinned strategy is the one that ran.
- 2 ranks with a batch of odd length (13 ids of one table): ring and
  all_to_all cannot split it and fall back to psum, still bit-identical.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dist_ranks as dr  # noqa: E402
from repro.embed import EmbeddingTable as JTable  # noqa: E402
from repro.embed import get_scheme as jscheme  # noqa: E402
from repro_torch.dist.collectives import run_ranks  # noqa: E402

NAMES = list(dr.KINDS)


def _reference(c: dict, vocabs=dr.VOCABS):
    """(the reference's output, its pool gradient of sum(out * g))."""
    kind, kw = dr.KINDS[c["name"]]
    table = JTable(jscheme(kind).build_config(vocabs, dr.DIM, dr.BUDGET,
                                              **kw))
    bufs = {}
    if "store_sets" in c:
        bufs = {"store_sets": jnp.asarray(c["store_sets"]),
                "store_lengths": jnp.asarray(c["store_lengths"])}
    ids = jnp.asarray(c["ids"])

    def f(mem):
        return dr.embed(table, {"memory": mem}, bufs, ids)

    mem = jnp.asarray(c["memory"])
    grad = jax.grad(lambda m: jnp.sum(f(m) * c["g"]))(mem)
    return np.asarray(f(mem)), np.asarray(grad)


@pytest.fixture(scope="module")
def four():
    cases = [dr.case(n, seed=i) for i, n in enumerate(NAMES)]
    return cases, run_ranks(dr.lookups, 4, cases, device="cpu")


@pytest.fixture(scope="module")
def two_odd():
    cases = [dr.case(n, seed=7, batch=13, fields=False)
             for n in ("lma", "hashed_elem")]
    return cases, run_ranks(dr.lookups, 2, cases, device="cpu")


@pytest.mark.parametrize("strategy", dr.STRATEGIES)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_lookup_bit_identical_to_reference(four, name, strategy):
    cases, ranks = four
    c = cases[NAMES.index(name)]
    want, want_grad = _reference(c)
    slab = dr.BUDGET // 4
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res[(name, strategy, "out")], want)
        np.testing.assert_allclose(res[(name, strategy, "grad")],
                                   want_grad[r * slab:(r + 1) * slab],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("strategy", dr.STRATEGIES)
@pytest.mark.parametrize("name", NAMES)
def test_pinned_strategy_is_the_one_that_ran(four, two_odd, name, strategy):
    for res in four[1]:
        assert res[(name, strategy, "ran")] == strategy
    if name in ("lma", "hashed_elem"):
        for res in two_odd[1]:
            assert res[(name, strategy, "ran")] == "psum"


@pytest.mark.parametrize("strategy", dr.STRATEGIES)
@pytest.mark.parametrize("buf", ["store_sets", "store_lengths",
                                 "partial_sum"])
def test_sharded_set_lookup_exact(four, strategy, buf):
    cases, ranks = four
    c = cases[NAMES.index("lma")]
    gids = (c["ids"] + np.array([0, dr.VOCABS[0]])).reshape(-1)
    want = c["store_sets" if buf == "partial_sum" else buf][gids]
    for res in ranks:
        got = res[("lma", strategy, buf)]
        np.testing.assert_array_equal(got.view(want.dtype), want)


@pytest.mark.parametrize("strategy", dr.STRATEGIES)
@pytest.mark.parametrize("name", ["lma", "hashed_elem"])
def test_odd_chunking_falls_back_bit_identical(two_odd, name, strategy):
    cases, ranks = two_odd
    c = next(x for x in cases if x["name"] == name)
    assert c["ids"].size % 2 == 1
    want, want_grad = _reference(c)
    slab = dr.BUDGET // 2
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res[(name, strategy, "out")], want)
        np.testing.assert_allclose(res[(name, strategy, "grad")],
                                   want_grad[r * slab:(r + 1) * slab],
                                   rtol=1e-6, atol=1e-6)
