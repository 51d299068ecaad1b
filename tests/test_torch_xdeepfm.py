"""Port xDeepFM vs the JAX reference, parameters carried across by
``params_from_jax``:
- the full-width config and its linear table equal the reference's (both
  pools flat, the linear pool's ``striped`` inherited);
- the smoke forward: both pools' lookups bit-identical, logits and loss
  within 1e-5 (float32 sums in another order);
- both pools under one sparse-gradient capture: one SparseGrad each, equal
  to the dense pool gradients within 1e-6;
- 5 training steps of the smoke config through both Trainers (sparse
  Adagrad on both pools): losses, parameters and accumulators within 1e-5;
- BatchingScorer serves batches with no ``dense`` key, or an empty one;
- the launcher runs ``--arch xdeepfm --smoke`` on the CPU, lma and
  hashed_elem.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.core.signatures import synthetic_dense_store  # noqa: E402
from repro.embed import EmbeddingTable as JTable  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.configs._recsys_common import XDEEPFM_VOCABS  # noqa: E402
from repro_torch.convert import buffers_from_numpy, params_from_jax  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402
from repro_torch.optim import sparse as sp  # noqa: E402
from repro_torch.serve import BatchingScorer, model_score_fn  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def test_full_width_config_matches_reference():
    j, t = jget("xdeepfm").make_model(), tget("xdeepfm").make_model()
    assert dataclasses.asdict(j.embedding) == dataclasses.asdict(t.embedding)
    assert dataclasses.asdict(jrec._linear_cfg(j)) == \
        dataclasses.asdict(trec.linear_config(t))
    assert (t.n_dense, t.cin_layers, t.deep_mlp) == (0, (200, 200, 200),
                                                      (400, 400))
    assert len(XDEEPFM_VOCABS) == 39 and sum(XDEEPFM_VOCABS) == 33_763_877
    p, lp = t.embedding.lma, trec.linear_config(t).lma
    assert (p.m, p.d, p.stripe, p.n_h, p.max_set, p.min_support) == \
        (21_102_592, 10, 0, 4, 32, 2)
    assert (lp.m, lp.d, lp.striped, lp.stripe) == (2_113_536, 1, False, 0)
    assert tget("xdeepfm").source == jget("xdeepfm").source


def _setup(kind="lma"):
    jcfg = jget("xdeepfm").make_smoke(embedding_kind=kind)
    tcfg = tget("xdeepfm").make_smoke(embedding_kind=kind)
    assert dataclasses.asdict(jcfg.embedding) == \
        dataclasses.asdict(tcfg.embedding)
    jparams = jrec.init(jax.random.key(4), jcfg)
    model = trec.init(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu"))
    jbufs, tbufs = {}, {}
    if kind == "lma":
        e = jcfg.embedding
        store = synthetic_dense_store(e.total_vocab, 16, max_set=e.lma.max_set)
        lengths = np.asarray(store.lengths).copy()
        lengths[::7] = 1                             # fallback rows
        jbufs = {"store_sets": store.sets, "store_lengths": jnp.asarray(lengths)}
        tbufs = buffers_from_numpy({k: np.asarray(v) for k, v in jbufs.items()},
                                   device="cpu")
    return jcfg, jparams, jbufs, tcfg, model, tbufs


def _batch(cfg, B, seed=0):
    rng = np.random.default_rng(seed)
    return {"sparse": np.stack([rng.integers(0, v, B)
                                for v in cfg.embedding.vocab_sizes],
                               1).astype(np.int32),
            "label": (rng.random(B) < 0.3).astype(np.float32)}


@pytest.mark.parametrize("kind", ["lma", "hashed_elem", "full"])
def test_forward_and_lookups_match_reference(kind):
    jcfg, jparams, jbufs, tcfg, model, tbufs = _setup(kind)
    batch = _batch(jcfg, 29, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    # both pools' lookups, bit-identical
    pairs = ((jcfg.table, tcfg.table, "embedding"),
             (JTable(jrec._linear_cfg(jcfg)), model.linear_table, "linear"))
    with torch.no_grad():
        for jt, tt, name in pairs:
            want = np.asarray(jax.jit(lambda p, ids: jt.embed_fields(
                p, jbufs, ids))(jparams[name], jb["sparse"]))
            got = tt.embed_fields(dict(getattr(model, name)), tbufs,
                                  tb["sparse"]).numpy()
            np.testing.assert_array_equal(got, want, err_msg=name)
        got = model(tb, tbufs).numpy()
        loss, aux = trec.loss_fn(model, tb, tbufs)
    want = np.asarray(jax.jit(lambda p, b: jrec.forward(p, jcfg, b, jbufs))(
        jparams, jb))
    assert got.shape == (29,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jloss, _ = jax.jit(lambda p, b: jrec.loss_fn(p, jcfg, b, jbufs))(
        jparams, jb)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(aux["logits"].numpy(), want, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("kind", ["lma", "hashed_elem"])
def test_two_pools_under_one_capture(kind):
    """Each pool's SparseGrad matches its own parameter and densifies to
    the dense gradient; neither pool gets a .grad."""
    _, _, _, tcfg, model, tbufs = _setup(kind)
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 40, 2).items()}
    loss, _ = trec.loss_fn(model, tb, tbufs)
    loss.backward()
    params = dict(model.named_parameters())
    dense = {k: p.grad.clone() for k, p in params.items()}
    model.zero_grad(set_to_none=True)
    with sp.capture() as cap:
        loss2, _ = trec.loss_fn(model, tb, tbufs)
        loss2.backward()
    assert float(loss2.detach()) == float(loss.detach())
    grads = cap.grads(params)
    assert set(grads) == {"embedding.memory", "linear.memory"}
    for name, g in grads.items():
        assert params[name].grad is None
        assert g.dense_shape == tuple(params[name].shape)
        np.testing.assert_allclose(g.densify().numpy(), dense[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    for name, p in params.items():
        if name not in grads:
            np.testing.assert_array_equal(p.grad.numpy(), dense[name].numpy())


def _jax_leaves(tree) -> dict:
    """Reference pytree -> {port parameter name: numpy array}, dense
    kernels transposed."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for kp, leaf in flat:
        parts = [str(getattr(k, "key", k)) for k in kp]
        if parts[-1] == "kernel":
            out[".".join(parts[:-1] + ["weight"])] = np.asarray(leaf).T
        else:
            out[".".join(parts)] = np.asarray(leaf)
    return out


def test_smoke_trainers_agree():
    """5 steps, sparse Adagrad on both pools, from the same parameters and
    batches: losses, parameters and accumulators within 1e-5."""
    arch_j, arch_t = jget("xdeepfm"), tget("xdeepfm")
    jcfg, tcfg = arch_j.make_smoke(), arch_t.make_smoke()
    n_s, B, steps = 600, 64, 5
    _, jbufs, jbatch, jloss = jlaunch._recsys_setup(arch_j, jcfg, n_s, B)
    _, tbufs, tbatch, tloss = tlaunch._recsys_setup(arch_t, tcfg, n_s, B,
                                                    "cpu")
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
    for pool in ("embedding.memory", "linear.memory"):
        assert tt.params[pool].grad is None
    want = _jax_leaves(jt.params)
    assert set(want) == set(tt.params)
    for name, p in tt.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-5, err_msg=name)
    jflat, _ = jax.tree_util.tree_flatten_with_path(jt.params)
    accs = _jax_leaves(jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jt.params), list(jt.opt_state)))
    for name in want:
        np.testing.assert_allclose(tt.opt_state[name].numpy(), accs[name],
                                   rtol=0, atol=1e-5, err_msg=f"acc {name}")
    assert len(jflat) == len(jt.opt_state)


@pytest.mark.parametrize("dense", [None, "empty"])
def test_batching_scorer_serves_xdeepfm(dense):
    _, _, _, tcfg, model, tbufs = _setup()
    batch = _batch(tcfg, 19, seed=6)
    scorer = BatchingScorer(model_score_fn(model, tbufs), max_batch=8,
                            max_delay_ms=5.0)
    try:
        pending = []
        for i in range(19):
            req = {"sparse": batch["sparse"][i]}
            if dense == "empty":
                req["dense"] = np.zeros((0,), np.float32)
            pending.append(scorer.submit(req))
        for p in pending:
            assert p.event.wait(30.0) and p.error is None
        got = np.asarray([p.result for p in pending], np.float32)
    finally:
        scorer.close()
    assert scorer.n_requests == 19 and scorer.n_batches < 19
    with torch.inference_mode():
        want = model({"sparse": torch.from_numpy(batch["sparse"])},
                     tbufs).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["lma", "hashed_elem"])
def test_launcher_xdeepfm_smoke_on_the_cpu(kind):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "xdeepfm", "--smoke", "--device", "cpu", "--embedding-kind", kind,
         "--steps", "4", "--batch", "32", "--n-signatures", "200",
         "--eval-batches", "1"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert f"xdeepfm ({kind})" in out.stdout
    assert "sparse memory-pool updates ON" in out.stdout
    done = [ln for ln in out.stdout.splitlines() if ln.startswith("done:")]
    assert done and "'step': 4" in done[0]
    ev = [ln for ln in out.stdout.splitlines() if ln.startswith("eval:")]
    assert ev and "'n': 2048" in ev[0]
