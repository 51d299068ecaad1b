"""DCN-v2, DIN and the Avazu LMA-DLRM in the port against the JAX
reference, parameters carried across by ``params_from_jax``: the configs
equal the reference's; logits and loss within 1e-6; 5 Trainer steps within
1e-5; ``retrieval`` within 1e-6 for dlrm, dcn and din over a C that is not a
multiple of ``chunk``; ``DINGenerator`` batches bit-equal; the launcher runs
the new archs and ``--embedding-kind freq`` on the CPU; and the
BatchingScorer serves DIN requests as a direct forward scores them."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.core.signatures import synthetic_dense_store  # noqa: E402
from repro.data.synthetic_ctr import DINGenerator as JDINGen  # noqa: E402
from repro.data.synthetic_ctr import DINSpec as JDINSpec  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs import din as tdin  # noqa: E402
from repro_torch.configs import lma_dlrm_avazu as tavazu  # noqa: E402
from repro_torch.convert import buffers_from_numpy, params_from_jax  # noqa: E402
from repro_torch.data.synthetic_ctr import DINGenerator, DINSpec  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402
from repro_torch.serve import BatchingScorer, model_score_fn  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ARCHS = ["dcn-v2", "din", "lma-dlrm-avazu"]


def _setup(arch, kind="lma", seed=1):
    jcfg = jget(arch).make_smoke(embedding_kind=kind)
    tcfg = tget(arch).make_smoke(embedding_kind=kind)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jparams = jrec.init(jax.random.key(seed), jcfg)
    model = trec.init(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu"))
    jbufs, tbufs = {}, {}
    if kind == "lma":
        e = jcfg.embedding
        store = synthetic_dense_store(e.total_vocab, 16, max_set=e.lma.max_set)
        lengths = np.asarray(store.lengths).copy()
        lengths[::11] = 0                            # fallback rows
        jbufs = {"store_sets": store.sets,
                 "store_lengths": jnp.asarray(lengths)}
        tbufs = buffers_from_numpy({k: np.asarray(v)
                                    for k, v in jbufs.items()}, device="cpu")
    return jcfg, jparams, jbufs, tcfg, model, tbufs


def _batch(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    e = cfg.embedding
    out = {"label": (rng.random(B) < 0.3).astype(np.float32)}
    if cfg.model == "din":
        L = cfg.hist_len
        out.update(hist=rng.integers(0, e.vocab_sizes[0], (B, L)).astype(
            np.int32), hist_mask=rng.random((B, L)) < 0.7,
            target=rng.integers(0, e.vocab_sizes[0], B).astype(np.int32))
        out["hist_mask"][0] = False                  # an empty history
        return out
    out["sparse"] = np.stack([rng.integers(0, v, B) for v in e.vocab_sizes],
                             1).astype(np.int32)
    if cfg.n_dense:
        out["dense"] = rng.normal(0, 1, (B, cfg.n_dense)).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for kind in ("lma", "hashed_elem", "qr", "md", "freq"):
        assert dataclasses.asdict(jget(arch).make_model(
            embedding_kind=kind)) == dataclasses.asdict(
            tget(arch).make_model(embedding_kind=kind)), kind
        assert dataclasses.asdict(jget(arch).make_smoke(
            embedding_kind=kind)) == dataclasses.asdict(
            tget(arch).make_smoke(embedding_kind=kind)), kind
    ja, ta = jget(arch), tget(arch)
    assert (ja.family, ja.optimizer, ja.learning_rate, ja.shapes,
            ja.source) == (ta.family, ta.optimizer, ta.learning_rate,
                           ta.shapes, ta.source)
    jcfg, tcfg = ja.make_model(), ta.make_model()
    assert trec.lookups_per_example(tcfg) == jrec.lookups_per_example(jcfg)


def test_full_width_sizes():
    from repro.configs.din import DIN_VOCABS
    from repro.configs.lma_dlrm_avazu import BENCH_VOCABS
    assert tdin.DIN_VOCABS == DIN_VOCABS
    assert tavazu.BENCH_VOCABS == BENCH_VOCABS
    dcn = tget("dcn-v2").make_model().embedding
    assert (dcn.budget, dcn.lma.stripe, dcn.dim) == (33_763_328, 2_110_208, 16)
    din = tget("din").make_model()
    assert (din.embedding.budget, din.embedding.lma.stripe) == (5_627_904, 0)
    assert trec.lookups_per_example(din) == 101
    avazu = tavazu.make_model(expansion=8.0, n_h=2)
    assert avazu.n_dense == 1 and avazu.embedding.lma.n_h == 2


@pytest.mark.parametrize("kind", ["lma", "freq"])
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_and_loss_within_1e6(arch, kind):
    jcfg, jparams, jbufs, tcfg, model, tbufs = _setup(arch, kind)
    batch = _batch(jcfg, 24)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = np.asarray(jrec.forward(jparams, jcfg, jb, jbufs))
    with torch.no_grad():
        got = model(tb, tbufs).numpy()
        loss, aux = trec.loss_fn(model, tb, tbufs)
    assert got.shape == (24,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    jloss, _ = jrec.loss_fn(jparams, jcfg, jb, jbufs)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(aux["logits"].numpy(), want, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("arch", ["dlrm-rm2", "dcn-v2", "din"])
def test_retrieval_within_1e6(arch):
    """C = 1,000 candidates in chunks of 128: the last chunk padded and
    sliced off; the scores equal the reference's scan and a direct forward
    of the same candidates."""
    jcfg, jparams, jbufs, tcfg, model, tbufs = _setup(arch)
    ctx = _batch(jcfg, 1, seed=4)
    ctx.pop("label")
    V = jcfg.embedding.vocab_sizes[0]
    cand = np.random.default_rng(5).integers(0, V, 1000).astype(np.int32)
    want = np.asarray(jrec.retrieval(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in ctx.items()},
        jnp.asarray(cand), jbufs, chunk=128))
    got = trec.retrieval(model, {k: torch.from_numpy(v)
                                 for k, v in ctx.items()},
                         torch.from_numpy(cand), tbufs, chunk=128)
    assert got.shape == (1000,) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # one chunk's scores are a direct forward of that chunk's batch
    direct = {k: torch.from_numpy(np.repeat(v, 128, axis=0))
              for k, v in ctx.items()}
    key = "target" if jcfg.model == "din" else "sparse"
    if key == "target":
        direct["target"] = torch.from_numpy(cand[:128])
    else:
        direct["sparse"][:, 0] = torch.from_numpy(cand[:128])
    with torch.no_grad():
        np.testing.assert_array_equal(model(direct, tbufs).numpy(),
                                      got[:128].numpy())


@pytest.mark.parametrize("arch,kind", [("dcn-v2", "lma"), ("din", "lma"),
                                       ("din", "freq"),
                                       ("lma-dlrm-avazu", "lma")])
def test_smoke_trainers_agree(arch, kind):
    """5 Adagrad steps (the pool on lazy sparse Adagrad) through both
    packages' Trainers from the same parameters and batches, the batches
    and buffers from each package's own ``_recsys_setup``: losses within
    1e-5."""
    arch_j, arch_t = jget(arch), tget(arch)
    jcfg = arch_j.make_smoke(embedding_kind=kind)
    tcfg = arch_t.make_smoke(embedding_kind=kind)
    n_s, B, steps = 300, 32, 5
    _, jbufs, jbatch, jloss = jlaunch._recsys_setup(arch_j, jcfg, n_s, B)
    _, tbufs, tbatch, tloss = tlaunch._recsys_setup(arch_t, tcfg, n_s, B,
                                                    "cpu")
    for k in jbufs:
        np.testing.assert_array_equal(
            tbufs[k].numpy().view(np.asarray(jbufs[k]).dtype),
            np.asarray(jbufs[k]))
    b0j, b0t = jbatch(0), tbatch(0)
    assert sorted(b0j) == sorted(b0t)
    for k in b0j:
        np.testing.assert_array_equal(np.asarray(b0j[k]), b0t[k])
    jparams = jrec.init(jax.random.key(0), jcfg)
    model = trec.init(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu"))
    jt = JTrainer(JTrainerConfig(total_steps=0, log_every=0), jloss, jparams,
                  jlaunch.make_optimizer(arch_j), jbatch)
    tt = Trainer(TrainerConfig(total_steps=0, log_every=0), tloss, model,
                 tlaunch.make_optimizer(arch_t), tbatch, device="cpu")
    assert jt.sparse_grads and tt.sparse_grads
    for s in range(1, steps + 1):
        jt.cfg.total_steps = tt.cfg.total_steps = s
        jl = jt.fit(log=lambda _: None)["loss"]
        tl = tt.fit(log=lambda _: None)["loss"]
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5,
                                   err_msg=f"step {s}")
    assert tt.params["embedding.memory"].grad is None


@pytest.mark.parametrize("idx", [0, 3, 20_000_001])
def test_din_generator_batches_bit_equal(idx):
    spec = dict(n_items=700, n_clusters=13, hist_len=17, seed=2)
    want = JDINGen(JDINSpec(**spec)).batch(33, idx)
    got = DINGenerator(DINSpec(**spec)).batch(33, idx)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    rows_j = list(JDINGen(JDINSpec(**spec)).rows_for_signatures(40))
    rows_t = list(DINGenerator(DINSpec(**spec)).rows_for_signatures(40))
    assert len(rows_t) == len(rows_j) == 40
    for a, b in zip(rows_t, rows_j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("args", [
    ["--arch", "din", "--smoke"],
    ["--arch", "dcn-v2", "--smoke"],
    ["--arch", "dlrm-rm2", "--smoke", "--embedding-kind", "freq"],
    ["--arch", "lma-dlrm-avazu", "--embedding-kind", "qr"],
])
def test_launcher_runs_on_the_cpu(args):
    out = tlaunch.main(args + ["--device", "cpu", "--steps", "4",
                               "--batch", "32", "--n-signatures", "200",
                               "--eval-batches", "1"])
    assert out["train"]["step"] == 4
    assert np.isfinite(out["train"]["loss"])
    assert 0.0 <= out["eval"]["auc"] <= 1.0


def test_batching_scorer_serves_din_requests():
    """Single DIN requests (hist [L], hist_mask [L], a scalar target) are
    padded into one device call; each score equals a direct forward."""
    jcfg, _, _, tcfg, model, tbufs = _setup("din")
    batch = _batch(tcfg, 9, seed=6)
    batch.pop("label")
    scorer = BatchingScorer(model_score_fn(model, tbufs), max_batch=16,
                            max_delay_ms=50.0)
    try:
        pend = [scorer.submit({k: v[i] for k, v in batch.items()})
                for i in range(9)]
        for p in pend:
            assert p.event.wait(30.0)
            assert p.error is None
    finally:
        scorer.close()
    with torch.no_grad():
        want = model({k: torch.from_numpy(v) for k, v in batch.items()},
                     tbufs).numpy()
    got = np.asarray([p.result for p in pend], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert scorer.n_requests == 9
