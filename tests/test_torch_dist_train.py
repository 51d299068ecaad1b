"""Sharded training in the port on 4 gloo ranks (CPU).

- 10 steps of sparse Adagrad, momentum SGD (0.9) and row-wise Adam on one
  table's pool (the reference's ``_TRAIN_SCRIPT`` loss, ``(e - y)^2``),
  for lma (striped, d = 16: a slab-aligned bucketed stream, each rank its
  K/4 slice and no update collective), hashed_row (a row-mode stream) and
  hashed_elem (a deduped flat stream, masked per rank), with the lookup and
  update exchanges pinned to psum and to all_to_all: the four slabs
  concatenated bit-identical to the port's one-process run (and the losses
  equal), and within 1e-6 of the reference's single-device run, the
  tolerance of ``tests/test_exchange.py:_TRAIN_SCRIPT``.
- A small DLRM (3 fields, narrow MLPs, a striped LMA pool) through the
  port's Trainer on 4 ranks for 5 steps: losses within 1e-5 of the
  reference's jitted Trainer, bit-equal to the port's one-process Trainer,
  losses and dense parameters equal across ranks, and only rank 0 logs.
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
from repro.models import recsys as jrec  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import sparse as jsp  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.dist.collectives import run_ranks  # noqa: E402

P = 4
ALGOS = ("adagrad", "sgd", "adam")
NAMES = ("lma", "hashed_row", "hashed_elem")
RUNS = [(n, a, s) for n in NAMES for a in ALGOS
        for s in ("psum", "all_to_all")]
LAYOUT = {"lma": (False, dr.DIM, (dr.BUDGET,)),
          "hashed_row": (True, 0, (dr.BUDGET // dr.DIM, dr.DIM)),
          "hashed_elem": (True, 0, (dr.BUDGET,))}


@pytest.fixture(scope="module")
def sharded():
    return run_ranks(dr.sparse_train_all, P, RUNS, device="cpu")


def _reference_train(name: str, algo: str, steps: int = 10) -> np.ndarray:
    """The reference's single-device sparse run of ``dr.sparse_train``."""
    kind, kw = dr.KINDS[name]
    table = JTable(jscheme(kind).build_config((512,), dr.DIM, dr.BUDGET,
                                              **kw))
    c = dr.case(name)
    bufs = {}
    if kind == "lma":
        sets, lengths = dr.store_arrays(512)
        bufs = {"store_sets": jnp.asarray(sets),
                "store_lengths": jnp.asarray(lengths)}
    params = {"embedding": {"memory": jnp.asarray(c["memory"])}}
    opt = {"adagrad": lambda: jsp.sparse_adagrad(0.1, eps=1e-8),
           "sgd": lambda: jsp.sparse_sgd(0.1, momentum=0.9),
           "adam": lambda: jsp.sparse_rowwise_adam(0.01)}[algo]()
    state = opt.init(params)

    def loss_fn(p, ids, y):
        e = table.embed(p["embedding"], bufs, 0, ids)
        loss = jnp.mean((e - y) ** 2)
        return loss, {"l": loss}

    vg = jsp.sparse_value_and_grad(loss_fn)
    for s in range(steps):
        ids, y = (jnp.asarray(a) for a in dr.train_batch(s))
        _, g = vg(params, ids, y)
        u, state = opt.update(g, state, params)
        params = jopt.apply_updates(params, u)
    return np.asarray(params["embedding"]["memory"])


@pytest.mark.parametrize("run", RUNS, ids=lambda r: "-".join(r))
def test_sparse_training_matches_one_process_and_reference(sharded, run):
    name, algo, _ = run
    losses, slabs, layouts = zip(*[r[run] for r in sharded])
    assert set(layouts) == {LAYOUT[name]}
    for x in losses[1:]:
        np.testing.assert_array_equal(x, losses[0])
    one_losses, one_pool, _ = dr.sparse_train(None, *run)
    np.testing.assert_array_equal(losses[0], one_losses)
    pool = np.concatenate(slabs)
    np.testing.assert_array_equal(pool, one_pool)
    np.testing.assert_allclose(pool, _reference_train(name, algo),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------- DLRM

def _jax_dlrm_config():
    from repro.models.recsys import RecsysConfig as JConfig
    e = jscheme("lma").build_config(dr.DLRM_VOCABS, dr.DIM, dr.BUDGET,
                                    seed=3, striped=True, max_set=dr.MAX_SET)
    return JConfig(name="dlrm-dist-test", model="dlrm", embedding=e,
                   n_dense=4, bot_mlp=(8, dr.DIM), top_mlp=(8, 1))


@pytest.fixture(scope="module")
def dlrm():
    jcfg = _jax_dlrm_config()
    jparams = jrec.init(jax.random.key(0), jcfg)
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    sets, lengths = dr.store_arrays(sum(dr.DLRM_VOCABS), seed=4)
    np_bufs = {"store_sets": sets, "store_lengths": lengths}
    jbufs = {k: jnp.asarray(v) for k, v in np_bufs.items()}
    opt = jopt.multi_transform([(r"(^|\.)memory$", jsp.sparse_adagrad(0.01))],
                               default=jopt.adagrad(0.01))
    jt = JTrainer(JTrainerConfig(total_steps=0, log_every=0),
                  lambda p, b: jrec.loss_fn(p, jcfg, b, jbufs), jparams, opt,
                  lambda s: {k: jnp.asarray(v)
                             for k, v in dr.dlrm_batch(s).items()})
    assert jt.sparse_grads
    jlosses = []
    for s in range(1, 6):
        jt.cfg.total_steps = s
        jlosses.append(jt.fit(log=lambda _: None)["loss"])
    return (np.asarray(jlosses), run_ranks(dr.dlrm_train, P, np_params,
                                           np_bufs, device="cpu"),
            dr.dlrm_train(None, np_params, np_bufs))


def test_dlrm_trainer_losses_match_reference(dlrm):
    jlosses, ranks, _ = dlrm
    for r in ranks:
        assert r["sparse"]
        np.testing.assert_allclose(r["losses"], jlosses, rtol=0, atol=1e-5)


def test_dlrm_trainer_bit_equal_to_one_process(dlrm):
    _, ranks, one = dlrm
    np.testing.assert_array_equal(ranks[0]["losses"], one["losses"])
    for k, v in one["params"].items():
        got = np.concatenate([r["params"][k] for r in ranks]) \
            if k.endswith("memory") else ranks[0]["params"][k]
        np.testing.assert_array_equal(got, v, err_msg=k)


def test_dlrm_trainer_ranks_agree_and_only_rank0_logs(dlrm):
    _, ranks, _ = dlrm
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["losses"], ranks[0]["losses"])
        for k, v in ranks[0]["params"].items():
            if not k.endswith("memory"):
                np.testing.assert_array_equal(r["params"][k], v, err_msg=k)
    assert ranks[0]["logged"] == 5
    assert all(r["logged"] == 0 for r in ranks[1:])
