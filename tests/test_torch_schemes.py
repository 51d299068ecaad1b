"""The qr, md and freq schemes of the port against the JAX reference,
parameters carried across as numpy: ``embed`` / ``embed_fields`` gathers
bit-identical (qr's product of two gathered rows too), md's small-K
projection within 1e-6, ``embed_bag`` (sum and mean) within 1e-6; the
schemes' sizing (``param_count``, qr's per-table budget, md's dims, freq's
hot tier), ``describe`` and ``list_schemes`` equal to the reference's;
freq's hot ids, row ids and locations bit-identical with seeds >= 2^31; the
resolver's choice on a card pool; freq under a (1, 4) mesh of gloo ranks
(the generic location lookup, every strategy) bit-identical to one
process; and 5 Trainer steps of dlrm-rm2's smoke config with each scheme
within 1e-5 of the reference's Trainer."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import _recsys_common as jrc  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.embed import EmbeddingTable as JTable  # noqa: E402
from repro.embed import freq as jfreq  # noqa: E402
from repro.embed import get_scheme as jscheme  # noqa: E402
from repro.embed import list_schemes as jlist  # noqa: E402
from repro.embed import schemes as jschemes  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import _recsys_common as trc  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import buffers_from_numpy, params_from_jax  # noqa: E402
from repro_torch.dist.collectives import run_ranks  # noqa: E402
from repro_torch.embed import (FUSED, SPLIT, EmbeddingTable,  # noqa: E402
                               get_scheme, list_schemes, resolve_backend)
from repro_torch.embed import freq as tfreq  # noqa: E402
from repro_torch.embed import schemes as tschemes  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_isolation import _OnCard  # noqa: E402
import dist_ranks as dr  # noqa: E402

KINDS = ["qr", "md", "freq"]
VOCABS = trc.smoke_vocabs(6)
BIG_SEED = 0xDEADBEEF             # >= 2^31, and so is BIG_SEED ^ 0x0F5EC


def _pair(kind, **kw):
    kw = dict(expansion=8.0, max_set=16, **kw)
    jcfg = jrc.embedding_of_kind(kind, VOCABS, 16, **kw)
    tcfg = trc.embedding_of_kind(kind, VOCABS, 16, **kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jt, tt = JTable(jcfg), EmbeddingTable(tcfg)
    jparams = jt.init(jax.random.key(0))
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in jparams.items()}
    jbufs, tbufs = {}, {}
    if kind == "freq":
        counts = np.random.default_rng(3).integers(0, 5, jcfg.total_vocab)
        jbufs = jt.make_buffers(counts)
        tbufs = buffers_from_numpy({k: np.asarray(v)
                                    for k, v in jbufs.items()}, device="cpu")
    return jcfg, jt, tt, jparams, tparams, jbufs, tbufs


def _ids(rng, B):
    return np.stack([rng.integers(0, v, B) for v in VOCABS], 1).astype(np.int32)


@pytest.mark.parametrize("kind", KINDS)
def test_embed_fields_and_embed_match(kind):
    """Gathers (and qr's elementwise product) bit-identical; md's
    projection, a product over K = md_dims[t] terms, within 1e-6."""
    _, jt, tt, jp, tp, jb, tb = _pair(kind)
    ids = _ids(np.random.default_rng(0), 40)
    got = tt.embed_fields(tp, tb, torch.from_numpy(ids)).numpy()
    want = np.asarray(jt.embed_fields(jp, jb, jnp.asarray(ids)))
    sub = ids[:, 3].reshape(8, 5)
    got1 = tt.embed(tp, tb, 3, torch.from_numpy(sub)).numpy()
    want1 = np.asarray(jt.embed(jp, jb, 3, jnp.asarray(sub)))
    assert got.shape == want.shape and got1.shape == want1.shape
    if kind == "md":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got1, want1, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got1, want1)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embed_bag_within_1e6(kind, mode):
    _, jt, tt, jp, tp, jb, tb = _pair(kind)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, VOCABS[2], (7, 6)).astype(np.int32)
    mask = rng.random((7, 6)) < 0.7
    mask[0] = False                                   # an empty bag
    got = tt.embed_bag(tp, tb, 2, torch.from_numpy(ids),
                       torch.from_numpy(mask), mode)
    want = jt.embed_bag(jp, jb, 2, jnp.asarray(ids), jnp.asarray(mask), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_params_describe_and_expansion_match(kind):
    jcfg, jt, tt, jp, tp, _, _ = _pair(kind)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(np.shape(jp[k])), k
    assert tt.param_count == jcfg.param_count() == \
        sum(int(np.prod(np.shape(v))) for v in jp.values())
    assert tt.config.expansion_rate == jcfg.expansion_rate
    assert get_scheme(kind).describe(tt.config) == \
        jscheme(kind).describe(jcfg)
    # the port draws its own parameters of the same names and shapes
    own = tt.init(device="cpu")
    assert {k: tuple(v.shape) for k, v in own.items()} == \
        {k: tuple(np.shape(v)) for k, v in jp.items()}


def test_list_schemes_and_describe_of_every_kind():
    assert list_schemes() == jlist()
    for kind in jlist():
        kw = dict(expansion=8.0, max_set=16)
        jcfg = jrc.embedding_of_kind(kind, VOCABS, 16, **kw)
        tcfg = trc.embedding_of_kind(kind, VOCABS, 16, **kw)
        assert get_scheme(kind).describe(tcfg) == \
            jscheme(kind).describe(jcfg), kind
        assert get_scheme(kind).buffer_specs(tcfg, 64) == \
            jscheme(kind).buffer_specs(jcfg, 64), kind
        assert get_scheme(kind).needs_signature_store == \
            jscheme(kind).needs_signature_store, kind
        assert get_scheme(kind).buffer_source == \
            jscheme(kind).buffer_source, kind


@pytest.mark.parametrize("vocabs,dim,budget", [
    (VOCABS, 16, 4096), (VOCABS, 16, 64), (trc.CRITEO_VOCABS, 64, 135_053_312),
    (trc.CRITEO_VOCABS, 16, 33_763_328), ((3, 5000, 10**6), 8, 9000),
    ((1, 2, 7), 4, 16)])
def test_qr_rows_and_budget_share(vocabs, dim, budget):
    """qr's table sizes equal the reference's and stay within each table's
    budget share (the assert in param_count); md's dims too."""
    total = sum(vocabs)
    for v in vocabs:
        mq, mr = tschemes._qr_rows(v, dim, budget, total)
        assert (mq, mr) == jschemes._qr_rows(v, dim, budget, total)
        assert mq + mr <= tschemes._qr_rows_budget(v, dim, budget, total) \
            == jschemes._qr_rows_budget(v, dim, budget, total)
    for kind in ("qr", "md"):
        jcfg = jscheme(kind).build_config(tuple(vocabs), dim, budget)
        tcfg = get_scheme(kind).build_config(tuple(vocabs), dim, budget)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert tcfg.param_count() == jcfg.param_count()
    assert tschemes.MDScheme._dims_for_budget(tuple(vocabs), dim, budget) \
        == jschemes.MDScheme._dims_for_budget(tuple(vocabs), dim, budget)


def test_qr_embeds_wrapped_quotients():
    """At a budget too small for ceil(v / mq) remainder rows the quotient
    index wraps (% mr), as the reference's does."""
    jcfg = jscheme("qr").build_config((5000, 97), 4, 64)
    tcfg = get_scheme("qr").build_config((5000, 97), 4, 64)
    jp = JTable(jcfg).init(jax.random.key(2))
    mq, mr = jp["q_0"].shape[0], jp["r_0"].shape[0]
    assert mr < -(-5000 // mq)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    ids = np.arange(0, 5000, 7, dtype=np.int32)
    np.testing.assert_array_equal(
        EmbeddingTable(tcfg).embed(tp, {}, 0, torch.from_numpy(ids)).numpy(),
        np.asarray(JTable(jcfg).embed(jp, {}, 0, jnp.asarray(ids))))


def test_qr_and_md_need_their_inputs():
    with pytest.raises(ValueError, match="budget"):
        get_scheme("qr").param_count(
            get_scheme("qr").build_config(VOCABS, 8, None))
    with pytest.raises(ValueError, match="md_dims"):
        get_scheme("md").param_count(
            get_scheme("md").build_config(VOCABS, 8, None))


@pytest.mark.parametrize("hot_k,budget", [(None, 4096), (3, 4096),
                                          (10**6, 4096), (0, 4096),
                                          (50, 32)])
def test_freq_hot_tier_sizes(hot_k, budget):
    jcfg = jscheme("freq").build_config(VOCABS, 16, budget, hot_k=hot_k)
    tcfg = get_scheme("freq").build_config(VOCABS, 16, budget, hot_k=hot_k)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    t, j = get_scheme("freq"), jscheme("freq")
    assert (t.hot_k(tcfg), t.tail_rows(tcfg)) == (j.hot_k(jcfg),
                                                  j.tail_rows(jcfg))
    assert t.tail_rows(tcfg) >= 1
    assert tfreq.DEFAULT_HOT_K == jfreq.DEFAULT_HOT_K
    with pytest.raises(ValueError, match="budget >= 2"):
        t.validate(t.build_config(VOCABS, 16, 16))


def test_freq_make_buffers_from_counts_with_ties():
    """Top-k by count, ties to the lower id, stored sorted; the buffer-less
    default is the first k ids; counts may be longer than the vocabulary."""
    jcfg = jscheme("freq").build_config(VOCABS, 16, 4096, hot_k=40)
    tcfg = get_scheme("freq").build_config(VOCABS, 16, 4096, hot_k=40)
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 3, jcfg.total_vocab + 9)   # many ties
    counts[jcfg.total_vocab:] = 100                     # past the vocab
    for store in (counts, None, torch.from_numpy(counts)):
        want = np.asarray(jscheme("freq").make_buffers(
            jcfg, None if store is None else counts)["freq_hot_ids"])
        got = get_scheme("freq").make_buffers(tcfg, store, device="cpu")
        assert got["freq_hot_ids"].dtype == torch.int32
        np.testing.assert_array_equal(got["freq_hot_ids"].numpy(), want)
    assert np.all(np.diff(want) > 0)
    with pytest.raises(ValueError, match="counts"):
        get_scheme("freq").make_buffers(tcfg, counts[:10], device="cpu")


@pytest.mark.parametrize("seed", [0, BIG_SEED])
@pytest.mark.parametrize("buffered", [True, False])
def test_freq_rows_and_locations_bit_identical(seed, buffered):
    """Hot ids (binary search, side left), tail ids (the hash under seed ^
    0x0F5EC), ids past the last hot id and below the first."""
    kw = dict(seed=seed, hot_k=25)
    jcfg = jscheme("freq").build_config(VOCABS, 16, 4096, **kw)
    tcfg = get_scheme("freq").build_config(VOCABS, 16, 4096, **kw)
    counts = np.zeros(jcfg.total_vocab, np.int64)
    counts[np.random.default_rng(seed & 0xFF).choice(
        jcfg.total_vocab, 25, replace=False)] = 7
    jb = jscheme("freq").make_buffers(jcfg, counts) if buffered else {}
    tb = buffers_from_numpy({k: np.asarray(v) for k, v in jb.items()},
                            device="cpu")
    gids = np.concatenate([np.arange(jcfg.total_vocab),
                           np.asarray(jb.get("freq_hot_ids", np.arange(25)))])
    gids = gids.astype(np.int32)
    for fn in ("sparse_row_ids", "locations"):
        want = np.asarray(getattr(jscheme("freq"), fn)(jcfg, jb,
                                                       jnp.asarray(gids)))
        got = getattr(get_scheme("freq"), fn)(tcfg, tb,
                                              torch.from_numpy(gids))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    rows = get_scheme("freq").sparse_row_ids(tcfg, tb, torch.from_numpy(gids))
    assert int(rows.max()) < tcfg.budget // tcfg.dim


def test_resolver_sends_freq_to_split_and_pools_with_a_spec_to_fused():
    """On a card pool, lma and the hashed schemes take the fused kernel and
    nothing else; freq, which has no fused spec (as in the reference, whose
    ``fused_eligible`` refuses it), takes the split path; on a CPU pool all
    take the split path; table schemes take none."""
    on_card = {"memory": _OnCard()}
    for kind in ("lma", "hashed_elem", "hashed_row", "freq"):
        cfg = trc.embedding_of_kind(kind, VOCABS, 16, expansion=8.0,
                                    max_set=16)
        scheme = get_scheme(kind)
        want = SPLIT if kind == "freq" else FUSED
        assert (scheme.fused_spec(cfg) is None) == (kind == "freq")
        assert resolve_backend(cfg, on_card) is want, kind
        assert resolve_backend(cfg, {"memory": torch.zeros(4)}) is SPLIT
    for kind in ("qr", "md", "full"):
        cfg = trc.embedding_of_kind(kind, VOCABS, 16)
        assert resolve_backend(cfg, {}) is None


@pytest.fixture(scope="module")
def freq_mesh():
    """freq's lookups on a (1, 4) mesh of gloo ranks (``dist_ranks.
    freq_lookups``, every strategy) and on one process."""
    c = dr.case("hashed_row", seed=31)        # a pool, field ids, g
    return c, run_ranks(dr.freq_lookups, 4, c, device="cpu"), dr.freq_lookups(None, c)


@pytest.mark.parametrize("strategy", dr.STRATEGIES)
def test_freq_under_a_mesh_matches_one_process(freq_mesh, strategy):
    """The generic location lookup (``sharded_location_lookup``) under each
    strategy: every rank's output bit-identical to the one-process lookup
    and to the reference's, the hot ids replicated, each slab's gradient
    within 1e-6 of the one-process gradient's slab."""
    c, ranks, one = freq_mesh
    jt = JTable(jscheme("freq").build_config(dr.VOCABS, dr.DIM, dr.BUDGET,
                                             seed=9, hot_k=dr.FREQ_HOT))
    want = jt.embed_fields({"memory": jnp.asarray(c["memory"])},
                           jt.make_buffers(dr.freq_counts()),
                           jnp.asarray(c["ids"]))
    np.testing.assert_array_equal(one[(None, "out")], np.asarray(want))
    slab = dr.BUDGET // 4
    for r, res in enumerate(ranks):
        assert res[(strategy, "ran")] == strategy
        np.testing.assert_array_equal(res[(strategy, "hot")],
                                      one[(None, "hot")])
        np.testing.assert_array_equal(res[(strategy, "out")],
                                      one[(None, "out")])
        np.testing.assert_allclose(res[(strategy, "grad")],
                                   one[(None, "grad")][r * slab:
                                                       (r + 1) * slab],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_dlrm_smoke_trainers_agree(kind):
    """dlrm-rm2's smoke config with ``kind``, Adagrad (the arch's; freq's
    pool on lazy sparse Adagrad in row mode, qr's and md's tables dense), 5
    steps from the same parameters and batches: losses within 1e-5."""
    arch_j, arch_t = jget("dlrm-rm2"), tget("dlrm-rm2")
    jcfg = arch_j.make_smoke(embedding_kind=kind)
    tcfg = arch_t.make_smoke(embedding_kind=kind)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    n_s, B, steps = 400, 64, 5
    _, jbufs, jbatch, jloss = jlaunch._recsys_setup(arch_j, jcfg, n_s, B)
    _, tbufs, tbatch, tloss = tlaunch._recsys_setup(arch_t, tcfg, n_s, B,
                                                    "cpu")
    assert sorted(jbufs) == sorted(tbufs)
    for k in jbufs:
        np.testing.assert_array_equal(tbufs[k].numpy(), np.asarray(jbufs[k]))
    jparams = jrec.init(jax.random.key(0), jcfg)
    model = trec.init(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu"))
    jt = JTrainer(JTrainerConfig(total_steps=0, log_every=0), jloss, jparams,
                  jlaunch.make_optimizer(arch_j), jbatch)
    tt = Trainer(TrainerConfig(total_steps=0, log_every=0), tloss, model,
                 tlaunch.make_optimizer(arch_t), tbatch, device="cpu")
    assert jt.sparse_grads == tt.sparse_grads == (kind == "freq")
    for s in range(1, steps + 1):
        jt.cfg.total_steps = tt.cfg.total_steps = s
        jl = jt.fit(log=lambda _: None)["loss"]
        tl = tt.fit(log=lambda _: None)["loss"]
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5,
                                   err_msg=f"step {s}")
    if kind == "freq":
        assert tt.params["embedding.memory"].grad is None
