"""The CSR signature store on the LMA lookup path, and the paper's analysis
helpers, against the JAX reference.

Integers and sets are bit-identical (sample ids, keys and seeds >= 2^31,
empty and over-long sets); floats within 1e-6.  Through the LMA scheme a
CSR store's locations, lookups and fused-kernel inputs equal the dense
store's, bit for bit, and the reference's CSR locations.  Under a (1, 4)
mesh of gloo ranks the store shards (``shard_csr``, equal to the
reference's) and its set rows and LMA lookups stay bit-identical under
every strategy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import allocation as ja  # noqa: E402
from repro.core import memory as jmem  # noqa: E402
from repro.core import minhash as jmh  # noqa: E402
from repro.core import signatures as js  # noqa: E402
from repro.embed import EmbeddingTable as JTable  # noqa: E402
from repro.embed import get_scheme as jscheme  # noqa: E402
from repro_torch.convert import buffers_from_numpy  # noqa: E402
from repro_torch.core import allocation as ta  # noqa: E402
from repro_torch.core import memory as tmem  # noqa: E402
from repro_torch.core import minhash as tmh  # noqa: E402
from repro_torch.core import signatures as ts  # noqa: E402
from repro_torch.dist.collectives import run_ranks  # noqa: E402
from repro_torch.dist.context import Mesh  # noqa: E402
from repro_torch.embed import EmbeddingTable, get_scheme  # noqa: E402
import dist_ranks as dr  # noqa: E402

D, M, MAX_SET = 16, 8192, 8


def _csr(n_values=60, seed=0):
    """A CSR store with sample ids >= 2^31, empty sets, sets of one and sets
    longer than MAX_SET."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 2 * MAX_SET, n_values).astype(np.int32)
    lengths[:3] = (0, 1, 3 * MAX_SET)
    offsets = np.zeros(n_values + 1, np.int32)
    np.cumsum(lengths, out=offsets[1:])
    flat = rng.integers(2**31, 2**32 - 1, int(offsets[-1]),
                        dtype=np.uint64).astype(np.uint32)
    return ts.SignatureStore(flat=flat, offsets=offsets, lengths=lengths)


def _jstore(s):
    return js.SignatureStore(flat=jnp.asarray(s.flat),
                             offsets=jnp.asarray(s.offsets),
                             lengths=jnp.asarray(s.lengths))


def test_gather_ragged_sets_bit_identical():
    s = _csr()
    ids = np.array([0, 1, 2, 5, 59, 2, 0, 17], np.int32)
    je, jm = jmh.gather_ragged_sets(jnp.asarray(s.flat),
                                    jnp.asarray(s.offsets),
                                    jnp.asarray(ids), MAX_SET)
    csr = ts.csr_on(s, "cpu")
    te, tm = tmh.gather_ragged_sets(csr.flat, csr.offsets,
                                    torch.from_numpy(ids), MAX_SET)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(te.numpy(),
                                  np.asarray(je).view(np.int32))


@pytest.mark.parametrize("a,b", [(set(), set()), ({1, 2}, set()),
                                 ({1, 2, 3}, {2, 3, 4, 2**31 + 5}),
                                 ({7}, {7})])
def test_jaccard_from_sets(a, b):
    assert tmh.jaccard_from_sets(a, b) == jmh.jaccard_from_sets(a, b)


@pytest.mark.parametrize("striped", [False, True])
@pytest.mark.parametrize("seed", [0x5C3A, 0x80000001])
def test_alloc_lma_csr_bit_identical(striped, seed):
    s = _csr(seed=seed % 5)
    jp = ja.LMAParams(d=D, m=M, n_h=2, max_set=MAX_SET, seed=seed,
                      striped=striped)
    tp = ta.LMAParams(**dataclasses.asdict(jp))
    ids = np.random.default_rng(1).integers(0, s.n_values, 97
                                            ).astype(np.int32)
    want = np.asarray(ja.alloc_lma(jp, _jstore(s), jnp.asarray(ids)))
    got = ta.alloc_lma(tp, s, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    # the CSR path equals the fixed-width store's, value for value
    dense = ts.densify_store(s, MAX_SET, device="cpu")
    np.testing.assert_array_equal(
        ta.alloc_lma(tp, dense, torch.from_numpy(ids)).numpy(), want)


def test_fraction_shared_and_expected_gamma():
    rng = np.random.default_rng(2)
    a = rng.integers(0, 50, (33, D)).astype(np.int32)
    b = np.where(rng.random((33, D)) < 0.5, a, a + 1).astype(np.int32)
    np.testing.assert_allclose(
        ta.fraction_shared(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(ja.fraction_shared(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=1e-6)
    phi = rng.random(9).astype(np.float32)
    for stripe in (0, M // D):
        np.testing.assert_allclose(
            ta.expected_gamma(torch.from_numpy(phi), M, stripe).numpy(),
            np.asarray(ja.expected_gamma(jnp.asarray(phi), M, stripe)),
            rtol=0, atol=1e-6)
        assert abs(ta.expected_gamma(0.25, M, stripe)
                   - float(ja.expected_gamma(0.25, M, stripe))) <= 1e-6


def test_cosine():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(7, 32)).astype(np.float32)
    b = rng.normal(size=(7, 32)).astype(np.float32)
    b[0] = 0.0                                   # the eps floor
    np.testing.assert_allclose(
        tmem.cosine(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jmem.cosine(jnp.asarray(a), jnp.asarray(b))),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 2**31 + 9])
def test_synthetic_signature_store_and_table_offsets_byte_identical(seed):
    want = js.synthetic_signature_store(40, 6, samples_per_value=12,
                                        overlap=0.7, seed=seed)
    got = ts.synthetic_signature_store(40, 6, samples_per_value=12,
                                       overlap=0.7, seed=seed)
    for k in ("flat", "offsets", "lengths"):
        w = np.asarray(getattr(want, k))
        g = getattr(got, k)
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes(), k
    vocabs = (3, 2**31 + 1, 17)
    w, g = js.table_offsets(vocabs), ts.table_offsets(vocabs)
    assert g.dtype == w.dtype and g.tobytes() == w.tobytes()


def _lma_cfg(kind_kw=None):
    return get_scheme("lma").build_config((40, 20), D, M, n_h=2,
                                          max_set=MAX_SET, seed=2**31 + 3,
                                          **(kind_kw or {}))


@pytest.mark.parametrize("striped", [None, False])
def test_lma_scheme_csr_buffers_match_dense_and_reference(striped):
    cfg = _lma_cfg({"striped": striped})
    s = _csr(cfg.total_vocab, seed=4)
    scheme = get_scheme("lma")
    csr = scheme.make_buffers(cfg, s, device="cpu")
    assert set(csr) == {"store_flat", "store_offsets", "store_lengths"}
    assert csr["store_flat"].dtype == torch.int32
    dense = scheme.make_buffers(cfg, ts.densify_store(s, MAX_SET,
                                                      device="cpu"))
    gids = torch.arange(cfg.total_vocab, dtype=torch.int32)
    loc = scheme.locations(cfg, csr, gids)
    np.testing.assert_array_equal(loc.numpy(),
                                  scheme.locations(cfg, dense, gids).numpy())
    (rows, sup), (drows, dsup) = (scheme.fused_inputs(cfg, b, gids)
                                  for b in (csr, dense))
    np.testing.assert_array_equal(rows.numpy(), drows.numpy())
    # the CSR support is |D_v| uncapped, the dense one capped at max_set:
    # the fallback test (support < min_support) reads them alike
    np.testing.assert_array_equal(sup.numpy(), s.lengths)
    np.testing.assert_array_equal((sup < cfg.lma.min_support).numpy(),
                                  (dsup < cfg.lma.min_support).numpy())
    # the reference's scheme over its own CSR buffers
    jcfg = jscheme("lma").build_config((40, 20), D, M, n_h=2,
                                       max_set=MAX_SET, seed=2**31 + 3,
                                       striped=striped)
    jbufs = jscheme("lma").make_buffers(jcfg, _jstore(s))
    np.testing.assert_array_equal(
        loc.numpy(), np.asarray(jscheme("lma").locations(
            jcfg, jbufs, jnp.asarray(gids.numpy()))))
    # its buffers carried across: store_flat as int32 bit patterns
    conv = buffers_from_numpy(jax.tree_util.tree_map(np.asarray, jbufs),
                              device="cpu")
    for k, v in csr.items():
        np.testing.assert_array_equal(conv[k].numpy(), v.numpy())
    # lookups through the table facade (the split path on the CPU)
    table = EmbeddingTable(cfg)
    params = table.init(device="cpu")
    ids = torch.tensor([[0, 1], [2, 19], [39, 0]], dtype=torch.int32)
    np.testing.assert_array_equal(
        table.embed_fields(params, csr, ids).numpy(),
        table.embed_fields(params, dense, ids).numpy())


def test_csr_store_trains_as_the_dense_store():
    """A sparse step reads the same locations from either store form."""
    from repro_torch.optim import sparse as sp

    cfg = _lma_cfg()
    s = _csr(cfg.total_vocab, seed=5)
    table = EmbeddingTable(cfg)
    params = table.init(device="cpu")
    grads = []
    for bufs in (table.make_buffers(s, device="cpu"),
                 table.make_buffers(ts.densify_store(s, MAX_SET,
                                                     device="cpu"))):
        mem = torch.nn.Parameter(params["memory"].clone())
        ids = torch.tensor([[0, 3], [7, 19], [39, 1]], dtype=torch.int32)
        with sp.capture() as cap:
            table.embed_fields({"memory": mem}, bufs, ids).square().sum(
            ).backward()
        grads.append(cap.grads({"memory": mem})["memory"])
    a, b = grads
    assert torch.equal(a.indices, b.indices)
    assert torch.equal(a.values, b.values)


def test_materialize_rows_matches_reference():
    cfg = _lma_cfg()
    s = _csr(cfg.total_vocab, seed=6)
    table = EmbeddingTable(cfg)
    jtable = JTable(jscheme("lma").build_config(
        (40, 20), D, M, n_h=2, max_set=MAX_SET, seed=2**31 + 3))
    jparams = jtable.init(jax.random.key(0))
    params = {"memory": torch.from_numpy(np.array(jparams["memory"]))}
    jbufs = jtable.make_buffers(_jstore(s))
    for t, n in ((0, None), (1, 7)):
        want = np.asarray(jtable.materialize_rows(jparams, jbufs, t, n))
        got = table.materialize_rows(params, table.make_buffers(
            s, device="cpu"), t, n)
        np.testing.assert_array_equal(got.numpy(), want)


def test_shard_csr_equals_reference():
    """``shard_csr`` (stacked, re-based, zero-padded) equals the
    reference's; ``shard_csr_buffers`` keeps a rank's row of it (without
    the padding) and its rows of the lengths, and leaves a store whose
    rows do not divide, or a mesh of one rank, as it is."""
    from repro.dist import sharded_memory as jsm
    from repro_torch.dist import sharded_memory as tsm
    s = _csr(64)
    for P in (1, 2, 4, 8):
        got = tsm.shard_csr(s.flat, s.offsets, P)
        want = jsm.shard_csr(s.flat, s.offsets, P)
        for a, b in zip(got, want):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))
    flat_sh, offs_sh = tsm.shard_csr(s.flat, s.offsets, 4)
    bufs = buffers_from_numpy({"store_flat": s.flat,
                               "store_offsets": s.offsets,
                               "store_lengths": s.lengths}, device="cpu")
    for r in range(4):
        part = tsm.shard_csr_buffers(bufs, Mesh(model=4, rank=r))
        assert sorted(part) == ["store_flat_sh", "store_lengths",
                                "store_offsets_sh"]
        n = int(part["store_offsets_sh"][-1])
        np.testing.assert_array_equal(
            part["store_flat_sh"][:n].numpy().view(np.uint32),
            flat_sh[r, :n])
        np.testing.assert_array_equal(part["store_offsets_sh"].numpy(),
                                      offs_sh[r])
        np.testing.assert_array_equal(part["store_lengths"].numpy(),
                                      s.lengths[r * 16:(r + 1) * 16])
    assert tsm.shard_csr_buffers(bufs, Mesh(model=3, rank=0)) is bufs
    assert tsm.shard_csr_buffers(bufs, Mesh(model=1)) is bufs
    with pytest.raises(ValueError):
        tsm.shard_csr(s.flat, s.offsets, 3)


@pytest.fixture(scope="module")
def csr_mesh():
    """The CSR store sharded over a (1, 4) mesh of gloo ranks
    (``dist_ranks.csr_lookups``, every strategy)."""
    c = dr.case("lma", seed=41)
    csr = dr.csr_arrays()
    return c, csr, run_ranks(dr.csr_lookups, 4, c, csr, device="cpu")


@pytest.mark.parametrize("strategy", dr.STRATEGIES)
def test_csr_store_under_a_mesh(csr_mesh, strategy):
    """On every rank, under each strategy: ``sharded_csr_set_lookup``'s
    rows, mask and support bit-identical to the reference's
    ``gather_ragged_sets`` on the whole store; the LMA lookup through the
    sharded CSR store bit-identical to the sharded dense store's and to
    the reference's lookup through the whole CSR store."""
    c, csr, ranks = csr_mesh
    gids = (c["ids"] + np.array([0, dr.VOCABS[0]])).reshape(-1)
    elems, mask = jmh.gather_ragged_sets(
        jnp.asarray(csr["store_flat"]), jnp.asarray(csr["store_offsets"]),
        jnp.asarray(gids), dr.MAX_SET)
    want_sets = np.where(np.asarray(mask), np.asarray(elems), 0)
    kind, kw = dr.KINDS["lma"]
    jt = JTable(jscheme(kind).build_config(dr.VOCABS, dr.DIM, dr.BUDGET,
                                           **kw))
    want = np.asarray(jt.embed_fields(
        {"memory": jnp.asarray(c["memory"])},
        {k: jnp.asarray(v) for k, v in csr.items()}, jnp.asarray(c["ids"])))
    for res in ranks:
        assert res["keys"] == ["store_flat_sh", "store_lengths",
                               "store_offsets_sh"]
        sets, m, sup = res[(strategy, "sets")]
        np.testing.assert_array_equal(sets.view(np.uint32), want_sets)
        np.testing.assert_array_equal(m, np.asarray(mask))
        np.testing.assert_array_equal(sup, csr["store_lengths"][gids])
        np.testing.assert_array_equal(res[(strategy, "csr")],
                                      res[(strategy, "dense")])
        np.testing.assert_array_equal(res[(strategy, "csr")], want)
        assert res[(strategy, "ran")] == strategy