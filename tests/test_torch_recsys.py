"""Port DLRM vs the JAX reference, parameters carried across by
``params_from_jax``: logits and loss within 1e-5 (float32 matmul order) for
both smoke configs; the port's BatchingScorer serves what a direct forward
computes."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.core.signatures import synthetic_dense_store  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs._recsys_common import (CRITEO_VOCABS,  # noqa: E402
                                                RECSYS_SHAPE_TABLE)
from repro_torch.convert import buffers_from_numpy, params_from_jax  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402
from repro_torch.serve import BatchingScorer, model_score_fn  # noqa: E402

ARCHS = ["dlrm-rm2", "lma-dlrm-criteo"]


def _setup(arch, kind="lma"):
    jcfg = jget(arch).make_smoke(embedding_kind=kind)
    tcfg = tget(arch).make_smoke(embedding_kind=kind)
    assert dataclasses.asdict(jcfg.embedding) == \
        dataclasses.asdict(tcfg.embedding)
    assert (jcfg.n_dense, jcfg.bot_mlp, jcfg.top_mlp) == \
        (tcfg.n_dense, tcfg.bot_mlp, tcfg.top_mlp)
    jparams = jrec.init(jax.random.key(1), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    model = trec.init(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(np_params, tcfg, device="cpu"))
    jbufs, tbufs = {}, {}
    if kind == "lma":
        e = jcfg.embedding
        store = synthetic_dense_store(e.total_vocab, 16, max_set=e.lma.max_set)
        lengths = np.asarray(store.lengths).copy()
        lengths[::11] = 0                            # fallback rows
        jbufs = {"store_sets": store.sets, "store_lengths": jnp.asarray(lengths)}
        tbufs = buffers_from_numpy({k: np.asarray(v) for k, v in jbufs.items()},
                                   device="cpu")
    return jcfg, jparams, jbufs, tcfg, model, tbufs


def _batch(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "dense": rng.normal(0, 1, (B, cfg.n_dense)).astype(np.float32),
        "sparse": np.stack([rng.integers(0, v, B)
                            for v in cfg.embedding.vocab_sizes],
                           1).astype(np.int32),
        "label": (rng.random(B) < 0.3).astype(np.float32),
    }


@pytest.mark.parametrize("arch", ARCHS)
def test_dlrm_logits_and_loss_match_reference(arch):
    jcfg, jparams, jbufs, tcfg, model, tbufs = _setup(arch)
    batch = _batch(jcfg, 24)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = np.asarray(jrec.forward(jparams, jcfg, jb, jbufs))
    with torch.no_grad():
        got = model(tb, tbufs).numpy()
        loss, aux = trec.loss_fn(model, tb, tbufs)
    assert got.shape == (24,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jloss, _ = jrec.loss_fn(jparams, jcfg, jb, jbufs)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(aux["logits"].numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["full", "hashed_elem"])
def test_dlrm_baseline_schemes_match_reference(kind):
    jcfg, jparams, jbufs, tcfg, model, tbufs = _setup("dlrm-rm2", kind)
    batch = _batch(jcfg, 9, seed=3)
    want = np.asarray(jrec.forward(jparams, jcfg,
                                   {k: jnp.asarray(v) for k, v in batch.items()},
                                   jbufs))
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in batch.items()},
                    tbufs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_full_width_config_matches_reference():
    j = jget("dlrm-rm2").make_model()
    t = tget("dlrm-rm2").make_model()
    assert dataclasses.asdict(j.embedding) == dataclasses.asdict(t.embedding)
    assert sum(CRITEO_VOCABS) == 33_762_577
    p = t.embedding.lma
    assert (p.m, p.stripe, p.n_raw_hashes, p.max_set, p.min_support) == \
        (135_053_312, 2_110_208, 256, 32, 2)
    assert t.d_interaction == 415
    assert RECSYS_SHAPE_TABLE["serve_p99"]["batch"] == 512
    with pytest.raises(ValueError, match="unknown recsys model"):
        trec.Recsys(dataclasses.replace(t, model="gnn"), device="cpu")


def test_batching_scorer_serves_direct_forward():
    """Requests scored through the port's scorer equal a direct forward on
    the same rows (1e-6: the padded bucket changes the matmul's row count,
    which may change the CPU GEMM's blocking)."""
    _, _, _, tcfg, model, tbufs = _setup("dlrm-rm2")
    batch = _batch(tcfg, 21, seed=5)
    scorer = BatchingScorer(model_score_fn(model, tbufs), max_batch=8,
                            max_delay_ms=5.0)
    try:
        pending = [scorer.submit({"dense": batch["dense"][i],
                                  "sparse": batch["sparse"][i]})
                   for i in range(21)]
        for p in pending:
            assert p.event.wait(30.0) and p.error is None
        got = np.asarray([p.result for p in pending], np.float32)
    finally:
        scorer.close()
    assert not scorer._worker.is_alive()
    assert scorer.n_requests == 21 and scorer.n_batches < 21
    with torch.inference_mode():
        want = model({k: torch.from_numpy(batch[k]) for k in
                      ("dense", "sparse")}, tbufs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
