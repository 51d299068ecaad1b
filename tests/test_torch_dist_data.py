"""The 'data' axis: a (data=2, model=2) mesh on 4 gloo ranks (CPU), against
the reference's single-device functions on the global batch (the
reference's own multi-device backward is not an oracle under this JAX).

One spawn (``dist_ranks.data_all``) runs every case.  Data index d holds
rows ``[d * B / 2, (d + 1) * B / 2)`` of each batch.

- lma (striped), hashed_row and hashed_elem under psum and all_to_all: the
  two data shares' outputs concatenated bit-identical to the reference's
  lookup of the global batch, on every rank; the 'model' slab gradients of
  ``sum(out * g)`` summed over 'data' within 1e-6 of the reference's
  ``jax.grad``; the pinned strategy is the one that ran.
- 10 steps of sparse Adagrad, momentum SGD and row-wise Adam through the
  guarded train step: replicas (the ranks with one model index) bit-equal;
  the slabs concatenated bit-equal to the port's one-process run (the
  global stream is rebuilt exactly: data shares are gathered in batch
  order, and halving a mean over a power of two is exact) and within 1e-6
  of the reference's single-device run, the tolerance of
  ``tests/test_exchange.py:_TRAIN_SCRIPT``; losses within 1e-6.
- The small DLRM through the port's Trainer (5 steps of the adagrad arm):
  losses within 1e-5 of the reference's jitted Trainer, every rank's losses
  and dense parameters bit-equal, replicas' slabs bit-equal, only world
  rank 0 logs.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import dist_ranks as dr  # noqa: E402
from test_torch_dist_lookup import _reference  # noqa: E402
from test_torch_dist_train import (_jax_dlrm_config,  # noqa: E402
                                   _reference_train)
from repro.models import recsys as jrec  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import sparse as jsp  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.dist.collectives import run_ranks  # noqa: E402

D, P = 2, 2
NAMES = ("lma", "hashed_row", "hashed_elem")
STRATEGIES = ("psum", "all_to_all")
RUNS = [(n, a, s) for n in NAMES for a in ("adagrad", "sgd", "adam")
        for s in STRATEGIES]


@pytest.fixture(scope="module")
def data_ranks():
    cases = [dr.case(n, seed=20 + i) for i, n in enumerate(NAMES)]
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
    jlosses = []
    for s in range(1, 6):
        jt.cfg.total_steps = s
        jlosses.append(jt.fit(log=lambda _: None)["loss"])
    ranks = run_ranks(dr.data_all, D * P, cases, RUNS, np_params, np_bufs,
                      data=D, device="cpu")
    return cases, ranks, np.asarray(jlosses)


def test_mesh_is_data_major(data_ranks):
    _, ranks, _ = data_ranks
    for w, r in enumerate(ranks):
        assert r["mesh"] == (D, P, w // P, w % P, w)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name", NAMES)
def test_lookup_over_data_bit_identical_to_reference(data_ranks, name,
                                                     strategy):
    cases, ranks, _ = data_ranks
    want, want_grad = _reference(cases[NAMES.index(name)])
    slab = dr.BUDGET // P
    for m in range(P):
        got = np.concatenate([ranks[d * P + m]["lookups"][(name, strategy,
                                                           "out")]
                              for d in range(D)])
        np.testing.assert_array_equal(got, want)
        grad = sum(ranks[d * P + m]["lookups"][(name, strategy, "grad")]
                   for d in range(D))
        np.testing.assert_allclose(grad, want_grad[m * slab:(m + 1) * slab],
                                   rtol=1e-6, atol=1e-6)
        for d in range(D):
            assert ranks[d * P + m]["lookups"][(name, strategy, "ran")] == \
                strategy


@pytest.mark.parametrize("run", RUNS, ids=lambda r: "-".join(r))
def test_sparse_training_over_data(data_ranks, run):
    name, algo, _ = run
    _, ranks, _ = data_ranks
    for m in range(P):
        for d in range(1, D):
            a, b = ranks[m]["train"][run], ranks[d * P + m]["train"][run]
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[0], b[0])
    pool = np.concatenate([ranks[m]["train"][run][1] for m in range(P)])
    one_losses, one_pool = dr.step_train(None, *run)
    np.testing.assert_array_equal(pool, one_pool)
    np.testing.assert_allclose(ranks[0]["train"][run][0], one_losses,
                               rtol=1e-6)
    np.testing.assert_allclose(pool, _reference_train(name, algo),
                               rtol=1e-6, atol=1e-6)


def test_dlrm_trainer_over_data(data_ranks):
    _, ranks, jlosses = data_ranks
    for r in ranks:
        assert r["dlrm"]["sparse"]
        np.testing.assert_allclose(r["dlrm"]["losses"], jlosses, rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(r["dlrm"]["losses"],
                                      ranks[0]["dlrm"]["losses"])
        for k, v in ranks[0]["dlrm"]["params"].items():
            if k.endswith("memory"):
                mine = ranks[r["mesh"][3]]["dlrm"]["params"][k]
                np.testing.assert_array_equal(r["dlrm"]["params"][k], mine)
            else:
                np.testing.assert_array_equal(r["dlrm"]["params"][k], v,
                                              err_msg=k)
    assert ranks[0]["dlrm"]["logged"] == 5
    assert all(r["dlrm"]["logged"] == 0 for r in ranks[1:])
