"""Training in the port on the CPU.

- The port's own sparse-vs-dense parity: 10 Adagrad steps through the
  port's Trainer with the pool's gradient as a SparseGrad, and again with
  the dense pool gradient, for lma (striped: bucketed), hashed_elem,
  hashed_row and full; every parameter and accumulator within 1e-6 (the
  mirror of ``tests/test_sparse_update.py::test_sparse_vs_dense_training_parity``;
  the two paths sum a slot's contributions in different orders).
- dlrm-rm2's smoke config through both packages' Trainers and launcher
  setups for 5 steps from the same parameters (``params_from_jax``) and
  batches: per-step losses within 1e-5, final parameters and Adagrad
  accumulators within 1e-5 (float32 matmuls and sums in another order).
- The data path's numpy copies give the reference's arrays exactly.
- The launcher runs end to end on the CPU.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.core import signatures as jsig  # noqa: E402
from repro.core.signatures import synthetic_dense_store  # noqa: E402
from repro.data import metrics as jmet  # noqa: E402
from repro.data.synthetic_ctr import CTRGenerator as JGen  # noqa: E402
from repro.data.synthetic_ctr import CTRSpec as JSpec  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import buffers_from_numpy, params_from_jax  # noqa: E402
from repro_torch.core import signatures as tsig  # noqa: E402
from repro_torch.data import metrics as tmet  # noqa: E402
from repro_torch.data.synthetic_ctr import CTRGenerator as TGen  # noqa: E402
from repro_torch.data.synthetic_ctr import CTRSpec as TSpec  # noqa: E402
from repro_torch.embed import EmbeddingTable, get_scheme  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402
from repro_torch.optim import optimizers as opt_lib  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

# --------------------------------------------------- sparse vs dense (port)


class _Probe(torch.nn.Module):
    """embedding fields -> a linear read-out (the reference test's model)."""

    def __init__(self, table):
        super().__init__()
        self.table = table
        self.embedding = torch.nn.ParameterDict(
            table.init(torch.Generator().manual_seed(1), device="cpu"))
        self.w = torch.nn.Parameter(torch.full((8,), 0.1))


def _probe_setup(kind):
    table = EmbeddingTable(get_scheme(kind).build_config((512, 256), 8, 4096,
                                                         seed=3))
    bufs = {}
    if get_scheme(kind).buffer_source == "signatures":
        store = synthetic_dense_store(table.config.total_vocab, 8, max_set=32,
                                      seed=2)
        bufs = buffers_from_numpy({"store_sets": np.asarray(store.sets),
                                   "store_lengths": np.asarray(store.lengths)},
                                  device="cpu")
    return _Probe(table), bufs


def _probe_batch(step):
    r = np.random.default_rng(step)
    ids = r.integers(0, 512, (48, 2)).astype(np.int32) % np.array([512, 256])
    return {"ids": ids.astype(np.int32),
            "y": r.normal(size=(48,)).astype(np.float32)}


def _probe_train(kind, sparse: bool):
    model, bufs = _probe_setup(kind)

    def loss_fn(m, b):
        e = m.table.embed_fields(dict(m.embedding), bufs, b["ids"])
        pred = torch.einsum("bfd,d->b", e, m.w)
        loss = torch.mean((pred - b["y"]) ** 2)
        return loss, {}

    trainer = Trainer(TrainerConfig(total_steps=10, log_every=0), loss_fn,
                      model, opt_lib.adagrad(0.1, eps=1e-8), _probe_batch,
                      sparse_grads=sparse, device="cpu")
    trainer.fit()
    return trainer


@pytest.mark.parametrize("kind", ["lma", "hashed_elem", "hashed_row", "full"])
def test_sparse_vs_dense_training_parity(kind):
    dense = _probe_train(kind, sparse=False)
    sparse = _probe_train(kind, sparse=True)
    for name, p in dense.params.items():
        np.testing.assert_allclose(
            sparse.params[name].detach().numpy(), p.detach().numpy(),
            rtol=1e-6, atol=1e-6, err_msg=f"{kind}: {name}")
        np.testing.assert_allclose(sparse.opt_state[name].numpy(),
                                   dense.opt_state[name].numpy(), rtol=1e-6,
                                   atol=1e-6)
    if kind != "full":
        assert sparse.params["embedding.memory"].grad is None
        assert dense.params["embedding.memory"].grad is not None


# ----------------------------------------- dlrm-rm2 smoke: both trainers


def _jax_name(path: str) -> tuple[str, bool]:
    """'bot/layer_0/kernel' -> ('bot.layer_0.weight', transposed)."""
    parts = path.split("/")
    if parts[-1] == "kernel":
        return ".".join(parts[:-1] + ["weight"]), True
    return ".".join(parts), False


def _jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for kp, leaf in flat:
        name, tr = _jax_name("/".join(str(getattr(k, "key", k)) for k in kp))
        out[name] = np.asarray(leaf).T if tr else np.asarray(leaf)
    return out


def test_dlrm_smoke_trainers_agree():
    arch_j, arch_t = jget("dlrm-rm2"), tget("dlrm-rm2")
    jcfg, tcfg = arch_j.make_smoke(), arch_t.make_smoke()
    n_s, B, steps = 600, 64, 5
    _, jbufs, jbatch, jloss = jlaunch._recsys_setup(arch_j, jcfg, n_s, B)
    _, tbufs, tbatch, tloss = tlaunch._recsys_setup(arch_t, tcfg, n_s, B,
                                                    "cpu")
    for k in ("store_sets", "store_lengths"):
        np.testing.assert_array_equal(
            np.asarray(jbufs[k]).view(np.int32), tbufs[k].numpy())
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
    want = _jax_leaves(jt.params)
    assert set(want) == set(tt.params)
    for name, p in tt.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-5, err_msg=name)
    # multi_transform keeps one state per leaf, in the params' flat order
    jflat, _ = jax.tree_util.tree_flatten_with_path(jt.params)
    for (kp, _), acc in zip(jflat, jt.opt_state):
        name, tr = _jax_name("/".join(str(getattr(k, "key", k))
                                      for k in kp))
        acc = np.asarray(acc)
        np.testing.assert_allclose(tt.opt_state[name].numpy(),
                                   acc.T if tr else acc, rtol=0, atol=1e-5,
                                   err_msg=f"acc {name}")


# ---------------------------------------------------------- the data path


def test_ctr_generator_signatures_and_eval_match_reference():
    kw = dict(n_fields=6, n_dense=4, vocab_sizes=(50, 3, 400, 17, 9, 120),
              n_clusters=3, value_dist="uniform", seed=5)
    jg, tg = JGen(JSpec(**kw)), TGen(TSpec(**kw))
    for step in (0, 3):
        jb, tb = jg.batch(257, step), tg.batch(257, step)
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(jb[k], tb[k])
    jstore = jsig.build_signature_store(jg.rows_for_signatures(300),
                                        jg.spec.total_vocab, max_per_value=8)
    tstore = tsig.build_signature_store(tg.rows_for_signatures(300),
                                        tg.spec.total_vocab, max_per_value=8)
    for k in ("flat", "offsets", "lengths"):
        np.testing.assert_array_equal(np.asarray(getattr(jstore, k)),
                                      getattr(tstore, k))
    dense = tsig.densify_store(tstore, 8, device="cpu")
    want = jsig.densify_store(jstore, 8)
    np.testing.assert_array_equal(np.asarray(want.sets).view(np.int32),
                                  dense.sets.numpy())
    rng = np.random.default_rng(0)
    jev, tev = jmet.StreamingEval(), tmet.StreamingEval()
    for _ in range(3):
        y = (rng.random(100) < 0.4).astype(np.float32)
        s = np.round(rng.normal(size=100), 1)           # ties
        jev.add(y, s)
        tev.add(y, s)
    assert jev.compute() == tev.compute()


def test_launcher_runs_on_the_cpu():
    out = tlaunch.main(["--device", "cpu", "--steps", "4", "--batch", "32",
                        "--n-signatures", "200", "--eval-batches", "1"])
    assert out["train"]["step"] == 4 and out["train"]["sparse_grads"]
    assert np.isfinite(out["train"]["loss"])
    assert 0.0 <= out["eval"]["auc"] <= 1.0 and out["eval"]["n"] == 2048
