"""The port's tiered memory store (``repro_torch.tier``) against the live
reference (``repro.tier``), inputs from numpy seeds, pools crossing as numpy:

- the budget helpers over a grid, equal to the reference;
- ``remap_locations`` bit-identical to the JAX function (sentinel pads,
  empty hot and stage tiers, block ids 0 .. n_blocks - 1);
- store round trips (``initial_compact``, stage / install / writeback,
  ``full_pool``) and ``retier`` (hysteresis, ``max_swaps``; hot set,
  counts, migrated values and moments, the EMA's float64 bits) bit-identical
  to the reference store; ``sanitize_cold``, the counts seed, the errors;
- the tiered ``embed_fields`` bit-identical to the resident lookup for
  hashed_elem, hashed_row, lma and freq;
- 25 tiered Adagrad steps with re-tiering: the reconstructed pool and
  accumulator bit-identical to the port's resident run and within 1e-6 of
  the reference's jitted tiered run, hot set, EMA and stats equal to its;
- the launcher's ``_maybe_tier`` (full-width DIN at B = 2, 32 MB, and the
  criteo refusal), the resolver's order, ``tier_fetch_bytes`` and
  ``make_optimizer``'s dense state layout.
"""
from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as jm  # noqa: E402
from repro.configs import _recsys_common as jrc  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.core.signatures import synthetic_dense_store  # noqa: E402
from repro.dist import exchange as jexchange  # noqa: E402
from repro.embed import EmbeddingTable as JTable  # noqa: E402
from repro.embed import get_scheme as jscheme  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro import tier as jtier  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JConfig  # noqa: E402
from repro_torch import tier  # noqa: E402
from repro_torch.checkpoint import manager as tm  # noqa: E402
from repro_torch.configs import _recsys_common as trc  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import buffers_from_numpy, state_to_jax  # noqa: E402
from repro_torch.dist import exchange as texchange  # noqa: E402
from repro_torch.dist.context import Mesh, use_mesh  # noqa: E402
from repro_torch.embed import (FUSED, SPLIT, TIERED,  # noqa: E402
                               EmbeddingTable, get_scheme, resolve_backend)
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402
from repro_torch.optim import optimizers as opt_lib  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_isolation import _OnCard  # noqa: E402


def _np(x):
    return np.asarray(jax.device_get(x)) if not isinstance(
        x, torch.Tensor) else x.detach().numpy()


# ------------------------------------------------------------ budget helpers

BUDGETS = [None, 0.001, 0.01, 0.5, 1.0, 7.3, 32.0, 1000.0]


@pytest.mark.parametrize("budget", [b for b in BUDGETS if b is not None])
@pytest.mark.parametrize("block", [64, 128, 512])
def test_budget_slots_equal_the_reference(budget, block):
    for itemsize in (2, 4, 8):
        assert tier.budget_slots(budget, itemsize, block) == \
            jtier.budget_slots(budget, itemsize, block)


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("n_leaves", [1, 2, 3])
def test_tier_split_and_needs_tiering_equal_the_reference(budget, n_leaves):
    for m in (4096, 200_000, 1 << 20, 5_627_904):
        for stage in (0, 16, 7_272, 10_000):
            for block in (128, 512):
                got = tier.tier_split(m, budget, 4, block, n_leaves, stage)
                assert got == jtier.tier_split(m, budget, 4, block,
                                               n_leaves, stage)
                assert sum(got) == m
                assert got == (m, 0) or got[0] % block == 0
        assert tier.needs_tiering(m, 4, budget, n_leaves) == \
            jtier.needs_tiering(m, 4, budget, n_leaves)


def test_tier_budget_mb_reads_the_env(monkeypatch):
    monkeypatch.delenv("REPRO_TIER_BUDGET_MB", raising=False)
    assert tier.tier_budget_mb() is None
    monkeypatch.setenv("REPRO_TIER_BUDGET_MB", "12.5")
    assert tier.tier_budget_mb() == jtier.tier_budget_mb() == 12.5


# ---------------------------------------------------------- remap identity

def _remap_case(seed, n_hot, n_staged, pad, block=64, n_blocks=32):
    rng = np.random.default_rng(seed)
    full = rng.normal(size=block * n_blocks).astype(np.float32)
    perm = rng.permutation(n_blocks)
    hot = np.sort(perm[:n_hot]).astype(np.int32)
    staged = np.sort(perm[n_hot:n_hot + n_staged]).astype(np.int32)
    stage_ids = np.concatenate([staged, np.full(pad, n_blocks, np.int32)])
    if not stage_ids.size:
        stage_ids = np.full(1, n_blocks, np.int32)
    rows = full.reshape(n_blocks, block)
    compact = np.concatenate([rows[hot].reshape(-1), rows[staged].reshape(-1),
                              np.zeros(pad * block, np.float32)])
    covered = np.concatenate([hot, staged])
    loc = (rng.choice(covered, (37, 5)) * block
           + rng.integers(0, block, (37, 5))).astype(np.int32)
    loc[0, :2] = [covered.min() * block, covered.max() * block + block - 1]
    return full, compact, hot, stage_ids, loc, block


@pytest.mark.parametrize("seed,n_hot,n_staged,pad", [
    (0, 10, 6, 2), (1, 0, 12, 0), (2, 31, 1, 3), (3, 32, 0, 0),
    (4, 1, 30, 1), (5, 16, 16, 0), (6, 0, 32, 4)])
def test_remap_locations_bit_identical(seed, n_hot, n_staged, pad):
    """The port's remap equals the JAX function's, and through it the
    compact gather equals the full gather."""
    full, compact, hot, stage_ids, loc, block = _remap_case(
        seed, n_hot, n_staged, pad)
    want = np.asarray(jtier.remap_locations(
        jnp.asarray(loc), jnp.asarray(hot), jnp.asarray(stage_ids), block))
    for blk in (block, torch.tensor(block, dtype=torch.int32)):
        got = tier.remap_locations(torch.from_numpy(loc),
                                   torch.from_numpy(hot),
                                   torch.from_numpy(stage_ids), blk)
        assert got.dtype == torch.int32 and got.shape == loc.shape
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(compact[want], full[loc])


def test_remap_locations_every_block_and_empty_tiers():
    """Block ids 0 .. n_blocks - 1 through the all-hot identity and an
    all-staged stage region, and an empty hot tier."""
    block, n_blocks = 4, 9
    loc = np.arange(block * n_blocks, dtype=np.int32).reshape(3, -1)
    for hot, stage in [(np.arange(n_blocks), np.full(1, n_blocks)),
                       (np.zeros(0), np.arange(n_blocks)),
                       (np.arange(0, n_blocks, 2),
                        np.concatenate([np.arange(1, n_blocks, 2),
                                        [n_blocks, n_blocks]]))]:
        hot, stage = hot.astype(np.int32), stage.astype(np.int32)
        want = np.asarray(jtier.remap_locations(
            jnp.asarray(loc), jnp.asarray(hot), jnp.asarray(stage), block))
        got = tier.remap_locations(torch.from_numpy(loc),
                                   torch.from_numpy(hot),
                                   torch.from_numpy(stage), block)
        np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ store protocol

def _stores(m=2048, block=128, hot_slots=512, seed=0, **kw):
    mem = np.random.default_rng(seed).normal(size=m).astype(np.float32)
    kw.setdefault("stage_blocks", (m - hot_slots) // block)
    return (mem, jtier.TieredStore(mem, hot_slots, block=block, **kw),
            tier.TieredStore(mem, hot_slots, block=block, device="cpu", **kw))


def _live(st, compact):
    n = 0 if st._staged_ids is None else st._staged_ids.size
    return _np(compact)[: st.hot_slots + n * st.block]


@pytest.mark.parametrize("blocks", [[0, 5, 9, 13], [4, 5, 6, 7], [0, 1],
                                    list(range(16)), []])
def test_store_round_trip_bit_identical(blocks):
    """initial_compact, stage / install, a step's edits, writeback and
    full_pool: the port's store holds the reference store's bits, two
    rounds (both host buffers)."""
    mem, js, ts = _stores()
    jt = {"memory": js.initial_compact()}
    tt = {"memory": ts.initial_compact()}
    np.testing.assert_array_equal(_np(tt["memory"]), _np(jt["memory"]))
    np.testing.assert_array_equal(ts.full_pool(tt["memory"]), mem)
    rng = np.random.default_rng(len(blocks))
    for rnd in range(2):
        b = np.asarray(blocks, np.int64)
        assert ts.stage(b) == js.stage(b)
        jt = js.install(jt)
        tt = ts.install(tt)
        np.testing.assert_array_equal(_live(ts, tt["memory"]),
                                      _live(js, jt["memory"]))
        np.testing.assert_array_equal(ts._staged_ids, js._staged_ids)
        bufs = ts.batch_tier_buffers()
        jbufs = js.batch_tier_buffers()
        for k in bufs:
            np.testing.assert_array_equal(_np(bufs[k]), _np(jbufs[k]))
        np.testing.assert_array_equal(ts.full_pool(tt["memory"]),
                                      js.full_pool(jt["memory"]))
        # a step: edit the hot slab and every staged row
        n = js.hot_slots + js._staged_ids.size * js.block
        delta = rng.normal(size=n).astype(np.float32)
        jt = {"memory": jt["memory"].at[:n].add(delta)}
        with torch.no_grad():
            tt["memory"][:n] += torch.from_numpy(delta)
        js.writeback(jt)
        ts.writeback(tt)
        np.testing.assert_array_equal(ts._host["memory"],
                                      js._host["memory"])
        np.testing.assert_array_equal(ts.full_pool(tt["memory"]),
                                      js.full_pool(jt["memory"]))
        blocks = list(reversed(blocks))
    assert ts.stats == js.stats


def test_store_device_buffers_and_stage_sizes():
    """The compact leaves keep their tensors (install writes in place);
    only the staged rows cross; compact_bytes counts every leaf."""
    _, _, ts = _stores(stage_blocks=4)
    leaf = ts.initial_compact()
    acc = torch.full((ts.compact_slots,), 0.1)
    tree = {"memory": leaf, "opt:acc": acc}
    ts.writeback(tree)
    ts.stage(np.array([6, 9]))
    out = ts.install(tree)
    assert out["memory"] is leaf and out["opt:acc"] is acc
    assert ts.compact_slots == 512 + 4 * 128
    assert ts.compact_bytes == 2 * ts.compact_slots * 4
    assert ts.stats["host_fetch_bytes"] == 2 * 2 * 128 * 4


def test_store_accepts_a_tensor_pool_and_defaults_to_the_card(monkeypatch):
    mem = np.arange(1024, dtype=np.float32)
    st = tier.TieredStore(torch.from_numpy(mem), 256, block=128,
                          stage_blocks=2)
    assert st.device.type == "cpu"
    np.testing.assert_array_equal(st.full_pool(st.initial_compact()), mem)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tier.TieredStore(mem, 256, block=128, stage_blocks=2)


def test_touched_blocks_equal_numpy_unique():
    rng = np.random.default_rng(7)
    loc = rng.integers(0, 2048, (50, 16)).astype(np.int32)
    _, js, ts = _stores()
    want = js.touched_blocks(jnp.asarray(loc))
    for x in (torch.from_numpy(loc), loc):
        got = ts.touched_blocks(x)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_stage_overflow_raises():
    _, js, ts = _stores(stage_blocks=2)
    for st in (js, ts):
        with pytest.raises(ValueError, match="stage capacity"):
            st.stage(np.array([5, 7, 9]))
    with pytest.raises(RuntimeError, match="without stage"):
        ts.install({"memory": ts.initial_compact()})


def test_register_leaf_rejects_nonuniform():
    _, _, ts = _stores()
    with pytest.raises(ValueError, match="uniform"):
        ts.register_leaf("opt", torch.arange(ts.compact_slots,
                                             dtype=torch.float32))
    ts.register_leaf("opt", torch.full((ts.compact_slots,), 0.25))
    assert (ts._host["opt"] == np.float32(0.25)).all()


def test_defaulted_stage_capacity_warns():
    mem = np.random.default_rng(0).normal(size=2048).astype(np.float32)
    with pytest.warns(UserWarning, match="saves no HBM"):
        tier.TieredStore(mem, 512, block=128, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tier.TieredStore(mem, 512, block=128, stage_blocks=4, device="cpu")
        tier.TieredStore(mem, 2048, block=128, device="cpu")


@pytest.mark.parametrize("hysteresis,max_swaps", [
    (1.0, None), (2.0, None), (1.0, 1), (1.05, 2), (1.0, 0)])
def test_retier_equals_the_reference(hysteresis, max_swaps):
    """Observations, then a re-tier with the moment leaf registered: hot
    set, counts, the EMA's float64 bits, the new slab and both full pools
    equal the reference store's."""
    mem, js, ts = _stores(m=4096, block=128, hot_slots=1024)
    acc0 = np.float32(0.1)
    jt = {"memory": js.initial_compact(),
          "opt:acc": jnp.full(js.compact_slots, acc0, jnp.float32)}
    tt = {"memory": ts.initial_compact(),
          "opt:acc": torch.full((ts.compact_slots,), float(acc0))}
    js.writeback(jt)
    ts.writeback(tt)
    rng = np.random.default_rng(int(hysteresis * 100) + (max_swaps or 0))
    for _ in range(3):
        b = np.unique(rng.integers(0, 32, 12))
        c = rng.integers(1, 50, b.size)
        js.observe(b, c)
        ts.observe(b, c)
    jt, jinfo = js.retier(jt, max_swaps=max_swaps, hysteresis=hysteresis)
    tt, tinfo = ts.retier(tt, max_swaps=max_swaps, hysteresis=hysteresis)
    assert tinfo == jinfo
    assert ts.hot_ids.dtype == np.int32
    np.testing.assert_array_equal(ts.hot_ids, js.hot_ids)
    np.testing.assert_array_equal(ts.ema.view(np.int64),
                                  js.ema.view(np.int64))
    for name in ("memory", "opt:acc"):
        np.testing.assert_array_equal(_np(tt[name])[: ts.hot_slots],
                                      _np(jt[name])[: js.hot_slots])
        np.testing.assert_array_equal(ts.full_pool(tt[name], name),
                                      js.full_pool(jt[name], name))
    np.testing.assert_array_equal(ts.full_pool(tt["memory"]), mem)
    assert ts.stats == js.stats
    meta, jmeta = ts.tier_meta(), js.tier_meta()
    for k in meta:
        assert meta[k].dtype == jmeta[k].dtype
        np.testing.assert_array_equal(meta[k], jmeta[k])


def test_restore_meta_and_drop_stage_equal_the_reference():
    _, js, ts = _stores(m=4096, block=128, hot_slots=1024, stage_blocks=4)
    ema = np.random.default_rng(1).random(32) * 10
    for hot in ([3, 8, 11, 14, 20, 21, 22, 31], [1, 2], None):
        js.restore_meta(hot, ema)
        ts.restore_meta(hot, ema)
        np.testing.assert_array_equal(ts.hot_ids, js.hot_ids)
        np.testing.assert_array_equal(ts.ema, js.ema)
    ts.stage(np.array([0, 1, 2]))
    ts.install({"memory": ts.initial_compact()})
    ts.drop_stage()
    assert ts._staged_ids is None
    assert ts.batch_tier_buffers()["tier_stage_ids"].tolist() == [32] * 4


def test_sanitize_cold_quarantines_only_cold():
    mem, js, ts = _stores(m=2048, block=128, hot_slots=512)
    for st in (js, ts):
        st._host["memory"][10, 5] = np.nan        # cold: quarantined
        st._host["memory"][1, 5] = np.nan         # hot: the device's
    n = ts.sanitize_cold()
    assert n == js.sanitize_cold() >= 1
    assert ts.stats["quarantined_cold_chunks"] == n
    np.testing.assert_array_equal(ts._host["memory"], js._host["memory"])
    assert not np.isnan(ts._host["memory"][10]).any()
    assert np.isnan(ts._host["memory"][1, 5])


def test_counts_seed_hot_set():
    mem = np.random.default_rng(3).normal(size=2048).astype(np.float32)
    counts = np.zeros(16)
    counts[[3, 8, 11, 14]] = [50, 40, 30, 20]
    counts[[5, 6]] = 30                           # ties: lower id first
    st = tier.TieredStore(mem, 512, block=128, stage_blocks=12,
                          counts=counts, device="cpu")
    ref = jtier.TieredStore(mem, 512, block=128, stage_blocks=12,
                            counts=counts)
    np.testing.assert_array_equal(st.hot_ids, ref.hot_ids)
    np.testing.assert_array_equal(st.hot_ids, [3, 5, 6, 8])
    np.testing.assert_array_equal(
        _np(st.initial_compact())[:512],
        mem.reshape(16, 128)[[3, 5, 6, 8]].reshape(-1))


# -------------------------------------------------- the public embed path

VOCABS = trc.smoke_vocabs(4)


def _tables(kind):
    kw = dict(expansion=4.0, max_set=16)
    jcfg = jrc.embedding_of_kind(kind, VOCABS, 16, **kw)
    tcfg = trc.embedding_of_kind(kind, VOCABS, 16, **kw)
    jt, tt = JTable(jcfg), EmbeddingTable(tcfg)
    jparams = jt.init(jax.random.key(0))
    jbufs = {}
    if kind == "lma":
        store = synthetic_dense_store(jcfg.total_vocab, 8, max_set=16, seed=2)
        jbufs = {"store_sets": store.sets,
                 "store_lengths": jnp.asarray(store.lengths)}
    elif kind == "freq":
        counts = np.random.default_rng(3).integers(0, 5, jcfg.total_vocab)
        jbufs = jt.make_buffers(counts)
    tbufs = buffers_from_numpy({k: np.asarray(v) for k, v in jbufs.items()},
                               device="cpu")
    return jcfg, tcfg, jt, tt, jparams, jbufs, tbufs


@pytest.mark.parametrize("kind", ["hashed_elem", "hashed_row", "lma",
                                  "freq"])
def test_tiered_embed_fields_bit_identical(kind):
    """The compact pool and the remap buffers in the embedding buffers: the
    port's tiered lookup bit-identical to its resident lookup and to the
    reference's tiered lookup; the resolver picks the tiered backend."""
    jcfg, tcfg, jt, tt, jparams, jbufs, tbufs = _tables(kind)
    mem = np.array(jparams["memory"])
    block = 64
    rng = np.random.default_rng(2)
    ids = np.stack([rng.integers(0, v, 48) for v in VOCABS], 1).astype(
        np.int32)
    want = tt.embed_fields({"memory": torch.from_numpy(mem)}, tbufs,
                           torch.from_numpy(ids)).numpy()
    offs = np.asarray(tcfg.table_offsets()[:-1], np.int32)
    gids = torch.from_numpy((ids + offs).reshape(-1))
    loc = get_scheme(kind).locations(tcfg, tbufs, gids)
    hot = (mem.size // block) // 4 * block
    st = tier.TieredStore(mem, hot, block=block, device="cpu",
                          stage_blocks=mem.size // block)
    js = jtier.TieredStore(mem, hot, block=block,
                           stage_blocks=mem.size // block)
    st.stage(st.touched_blocks(loc)[0])
    tree = st.install({"memory": st.initial_compact()})
    tb = {**tbufs, **st.batch_tier_buffers()}
    assert resolve_backend(tcfg, tree, get_scheme(kind), tb) is TIERED
    got = tt.embed_fields(tree, tb, torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got, want)
    js.stage(js.touched_blocks(np.asarray(loc))[0])
    jtree = js.install({"memory": js.initial_compact()})
    ref = jt.embed_fields(jtree, {**jbufs, **js.batch_tier_buffers()},
                          jnp.asarray(ids))
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_resolver_puts_tiered_first():
    """Tiered ahead of a mesh and of the fused kernel; without tier keys
    the resolver is unchanged."""
    cfg = trc.embedding_of_kind("hashed_elem", VOCABS, 16, expansion=4.0)
    tb = {"tier_hot_ids": torch.zeros(1, dtype=torch.int32)}
    with use_mesh(Mesh(model=4, rank=1)):
        assert resolve_backend(cfg, {"memory": torch.zeros(4)}, None,
                               tb) is TIERED
    assert resolve_backend(cfg, {"memory": _OnCard()}, None, tb) is TIERED
    assert resolve_backend(cfg, {"memory": _OnCard()}, None, {}) is FUSED
    assert resolve_backend(cfg, {"memory": torch.zeros(4)}) is SPLIT
    assert tier.tiered_active(tb) and not tier.tiered_active({})
    assert tier.split_batch({"a": 1, **{k: 2 for k in tier.TIER_KEYS}}) == (
        {"a": 1}, {k: 2 for k in tier.TIER_KEYS})


def test_tier_fetch_bytes_equals_the_reference():
    for args in [(0, 512), (31_000, 512, 2), (7, 128, 3, 2), (1, 64, 1, 8)]:
        assert texchange.tier_fetch_bytes(*args) == \
            jexchange.tier_fetch_bytes(*args)


# ------------------------------------------- end-to-end training parity

ECFG = dict(kind="hashed_elem", vocab_sizes=(1000, 500), dim=16, budget=4096)


def _problem():
    from repro.embed.config import EmbeddingConfig as JConfigE
    from repro_torch.embed.config import EmbeddingConfig
    jcfg, tcfg = JConfigE(**ECFG), EmbeddingConfig(**ECFG)
    jtable, ttable = JTable(jcfg), EmbeddingTable(tcfg)
    jparams = {"embedding": jtable.init(jax.random.key(1))}
    mem = np.asarray(jparams["embedding"]["memory"])
    offs = np.asarray(tcfg.table_offsets()[:-1], np.int32)

    def raw_batch(step):
        r = np.random.default_rng(step)
        return {"ids": np.stack([r.integers(0, 1000, 64),
                                 r.integers(0, 500, 64)], 1).astype(np.int32),
                "y": r.normal(size=(64, 2, 16)).astype(np.float32)}

    return jcfg, tcfg, jtable, ttable, jparams, mem, offs, raw_batch


class _Pool(torch.nn.Module):
    def __init__(self, mem):
        super().__init__()
        self.embedding = torch.nn.ParameterDict(
            {"memory": torch.from_numpy(np.array(mem))})


def _port_fit(tcfg, ttable, mem, offs, raw_batch, ctrl, steps=25):
    model = _Pool(mem if ctrl is None else
                  ctrl.store.initial_compact().numpy())

    def loss(model, b):
        batch, tb = tier.split_batch(b)
        e = ttable.embed_fields(dict(model.embedding), tb, batch["ids"])
        return torch.mean((e - batch["y"]) ** 2), {}

    tr = Trainer(TrainerConfig(total_steps=steps, log_every=0), loss, model,
                 opt_lib.adagrad(0.1), raw_batch, sparse_grads=False,
                 device="cpu", tier=ctrl)
    return tr, tr.fit(log=lambda s: None)


def test_tiered_training_parity():
    """25 Adagrad steps over a 4x over-budget pool, re-tiering every 4: the
    port's reconstructed pool and accumulator bit-identical to its resident
    run and within 1e-6 of the reference's jitted tiered run; the hot set,
    EMA and stats equal the reference's; the result carries the tier's six
    fields."""
    jcfg, tcfg, jtable, ttable, jparams, mem, offs, raw_batch = _problem()
    scheme = get_scheme(tcfg.kind)
    oracle, _ = _port_fit(tcfg, ttable, mem, offs, raw_batch, None)

    st = tier.TieredStore(mem, 1024, block=128, stage_blocks=24,
                          device="cpu")

    def plan(batch):
        g = torch.from_numpy((batch["ids"] + offs).reshape(-1))
        return scheme.locations(tcfg, {}, g)

    ctrl = tier.TierController(st, raw_batch, plan, retier_every=4)
    tiered, out = _port_fit(tcfg, ttable, mem, offs, raw_batch, ctrl)
    assert st.stats["promoted"] > 0, "re-tiering never fired"
    full = ctrl.export_params(tiered.params)["embedding.memory"].numpy()
    np.testing.assert_array_equal(
        full, oracle.params["embedding.memory"].detach().numpy())
    (_, acc_c), = tier.pool_leaf_paths(tiered.opt_state, st.compact_slots)
    (_, acc_o), = tier.pool_leaf_paths(oracle.opt_state, st.m)
    np.testing.assert_array_equal(
        st.full_pool(acc_c, "opt:embedding.memory"), acc_o.numpy())
    assert set(st._host) == {"memory", "opt:embedding.memory"}

    # the reference's tiered run (tests/test_tier.py's setup)
    jscheme_ = jscheme(jcfg.kind)

    def jloss(p, b):
        batch, tb = jtier.split_batch(b)
        e = jtable.embed_fields(p["embedding"], tb, batch["ids"])
        l = jnp.mean((e - batch["y"]) ** 2)
        return l, {"l": l}

    js = jtier.TieredStore(mem, 1024, block=128, stage_blocks=24)

    def jplan(batch):
        g = (np.asarray(batch["ids"]) + offs).reshape(-1)
        return jscheme_.locations(jcfg, {}, jnp.asarray(g))

    def jbatch(step):
        return {k: jnp.asarray(v) for k, v in raw_batch(step).items()}

    jctrl = jtier.TierController(js, jbatch, jplan, retier_every=4)
    jp = {"embedding": dict(jparams["embedding"],
                            memory=js.initial_compact())}
    jtr = JTrainer(JConfig(total_steps=25, log_every=0), jloss, jp,
                   jopt.adagrad(0.1), jbatch, sparse_grads=False, tier=jctrl)
    jout = jtr.fit(log=lambda s: None)
    jfull = np.asarray(jctrl.export_params(jtr.params)["embedding"]["memory"])
    np.testing.assert_allclose(full, jfull, rtol=0, atol=1e-6)
    (_, jacc), = jtier.pool_leaf_paths(jtr.opt_state, js.compact_slots)
    jname, = [k for k in js._host if k != "memory"]
    np.testing.assert_allclose(st.full_pool(acc_c, "opt:embedding.memory"),
                               js.full_pool(jacc, jname), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(st.hot_ids, js.hot_ids)
    np.testing.assert_array_equal(st.ema, js.ema)
    assert st.stats == js.stats
    for k in ("tier_hot_rows", "tier_cold_rows",
              "tier_staged_blocks_per_step", "tier_host_fetch_bytes_per_step",
              "tier_promoted", "tier_demoted"):
        assert out[k] == jout[k], k
    assert out["tier_hot_rows"] == 1024 and out["tier_sec"] > 0
    np.testing.assert_allclose(out["loss"], jout["loss"], rtol=1e-6)


def test_controller_on_restore_drops_staged_rows():
    _, _, _, _, _, mem, _, _ = _problem()
    st = tier.TieredStore(mem, 1024, block=128, stage_blocks=24,
                          device="cpu")
    st.stage(np.array([9, 10]))
    tree = st.install({"memory": st.initial_compact()})
    ctrl = tier.TierController(st, lambda s: {}, lambda b: None)
    assert st._staged_ids.size == 2
    assert ctrl.on_restore() is None
    assert st._staged_ids is None
    st.writeback(tree)                          # a clean no-op
    assert st.stats["writeback_bytes"] == 0


def test_controller_finds_adam_moments_by_name():
    """Dense Adam keeps mu and nu under the pool's name: both become store
    leaves (``opt:#1/...``, ``opt:#2/...``); the step counter does not."""
    _, _, _, _, _, mem, _, _ = _problem()
    st = tier.TieredStore(mem, 1024, block=128, stage_blocks=8, device="cpu")
    model = _Pool(st.initial_compact().numpy())
    params = dict(model.named_parameters())
    state = opt_lib.adam(0.01).init(params)
    ctrl = tier.TierController(st, lambda s: {}, lambda b: None)
    assert sorted(ctrl._collect(params, state)) == [
        "memory", "opt:#1/embedding.memory", "opt:#2/embedding.memory"]
    full_p, full_o = ctrl.export_full(params, state)
    assert isinstance(full_p["embedding.memory"], np.ndarray)
    assert full_o.mu["embedding.memory"].shape == (4096,)
    assert full_o.step == 0


# --------------------------------------------------------------- launcher

def test_launcher_maybe_tier_matches_the_reference():
    """Full-width DIN at B = 2 under 32 MB: the port's split (hot slots,
    stage blocks, compact slots) equals the reference launcher's, its
    compact leaves fit the budget, one controller step stays within the
    staging bound; the criteo pool, smaller than a step's working set, is
    refused by both."""
    arch_j, arch_t = jget("din"), tget("din")
    jcfg, tcfg = arch_j.make_model(None), arch_t.make_model(None)
    _, jbufs, jbatch, _ = jlaunch._recsys_setup(arch_j, jcfg, 300, 2)
    # the reference's buffers and batches (the port's DINGenerator is a
    # copy of its, and a full-width one takes seconds to build)
    tbufs = buffers_from_numpy({k: np.asarray(v) for k, v in jbufs.items()},
                               device="cpu")

    def tbatch(step):
        return {k: np.array(v) for k, v in jbatch(step).items()}

    jparams = jrec.init(jax.random.key(0), jcfg)
    jtiered, _, jctrl = jlaunch._maybe_tier(jcfg, arch_j, jparams, jbufs,
                                            jbatch, 32.0)
    model = trec.init(tcfg, device="cpu")
    loss, ctrl = tlaunch._maybe_tier(tcfg, arch_t, model, tbufs, tbatch, 32.0)
    st, js = ctrl.store, jctrl.store
    assert (st.hot_slots, st.stage_blocks, st.compact_slots, st.block) == (
        js.hot_slots, js.stage_blocks, js.compact_slots, js.block)
    assert tlaunch.MOMENT_LEAVES == {
        k: v for k, v in jlaunch.MOMENT_LEAVES.items() if k != "adafactor"}
    n_leaves = 1 + tlaunch.MOMENT_LEAVES[arch_t.optimizer]
    assert n_leaves * st.compact_slots * 4 <= 32 * 2**20 < n_leaves * st.m * 4
    assert model.embedding["memory"].shape == (st.compact_slots,)
    params = dict(model.named_parameters())
    _, _, info = ctrl.pre_step(0, params, opt_lib.adagrad(0.1).init(params))
    _, _, jinfo = jctrl.pre_step(0, jtiered, {})
    assert 0 < info["staged"] == jinfo["staged"] <= st.stage_blocks

    arch_cj, arch_ct = jget("lma-dlrm-criteo"), tget("lma-dlrm-criteo")
    cj, ct = arch_cj.make_model(None), arch_ct.make_model(None)
    _, bj, fj, _ = jlaunch._recsys_setup(arch_cj, cj, 300, 4)
    _, bt, ft, _ = tlaunch._recsys_setup(arch_ct, ct, 300, 4, "cpu")
    with pytest.raises(SystemExit, match="stage regions alone"):
        jlaunch._maybe_tier(cj, arch_cj, jrec.init(jax.random.key(0), cj),
                            bj, fj, 0.5)
    with pytest.raises(SystemExit, match="stage regions alone"):
        tlaunch._maybe_tier(ct, arch_ct, trec.init(ct, device="cpu"), bt, ft,
                            0.5)
    # untiered: no budget, a budget the pool fits, xDeepFM's two pools
    assert tlaunch._maybe_tier(ct, arch_ct, None, bt, ft, None) == (None,
                                                                  None)


@pytest.mark.parametrize("optimizer", ["adagrad", "sgd", "adam"])
@pytest.mark.parametrize("how", ["env", "sparse_ok"])
def test_make_optimizer_dense_state_layout(optimizer, how, monkeypatch):
    """With ``REPRO_SPARSE_GRADS=0`` or ``sparse_ok=False`` both launchers'
    ``make_optimizer`` return the plain dense optimizer: the port's state,
    carried across by ``state_to_jax(multi=False)``, has the reference's
    paths, shapes and dtypes; with both on, the port routes the pool to
    the sparse optimizer."""
    arch_j = dataclasses.replace(jget("dlrm-rm2"), optimizer=optimizer)
    arch_t = dataclasses.replace(tget("dlrm-rm2"), optimizer=optimizer)
    jcfg, tcfg = arch_j.make_smoke(), arch_t.make_smoke()
    jparams = jrec.init(jax.random.key(0), jcfg)
    model = trec.init(tcfg, device="cpu")
    params = dict(model.named_parameters())
    routed = tlaunch.make_optimizer(arch_t).init(params)
    assert isinstance(routed, dict) and set(routed) == set(params)
    kw = {"sparse_ok": False} if how == "sparse_ok" else {}
    if how == "env":
        # the reference reads the gate once, at import
        from repro.optim import sparse as jsparse
        monkeypatch.setenv("REPRO_SPARSE_GRADS", "0")
        monkeypatch.setattr(jsparse, "ENABLED", False)
    jstate = jlaunch.make_optimizer(arch_j, **kw).init(jparams)
    tstate = tlaunch.make_optimizer(arch_t, **kw).init(params)
    dense = {"adagrad": opt_lib.adagrad, "sgd": opt_lib.sgd,
             "adam": opt_lib.adam}[optimizer](0.1, **(
                 {"momentum": 0.9} if optimizer == "sgd" else {}))
    assert type(tstate) is type(dense.init(params))
    from repro_torch.train.trainer import _nested
    want = jm._flatten(jax.tree_util.tree_map(np.asarray, jstate))
    got = tm._flatten(state_to_jax(
        {"opt_state": _nested(tstate)}, multi=False)["opt_state"])
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(tm._host(got[k])), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
