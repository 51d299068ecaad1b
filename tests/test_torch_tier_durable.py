"""The port's tiered Trainer with durability, against its clean tiered run
and the reference's tiered Trainer (``tests/test_durability.py``'s tiered
setup, in both packages: a 4096-slot hashed_elem pool, 1024 hot slots, 24
staged blocks of 128, re-tiering every 4 steps, Adagrad 0.1):

- resume after a preemption: full pools, moments and tier meta
  bit-identical to the uninterrupted run; the checkpoint holds full pools
  and ``tier/hot_ids`` (int32) and ``tier/ema`` (float64);
- a checkpoint without tier meta restores the compact pools and drops the
  staged rows;
- a guard rollback drops the staged rows and heals to the clean bits;
- ``stage_fail`` is retried once and invisible;
- the tiered chaos soak (all five transient faults) ends bit-identical to
  the clean tiered run, its counters equal to the reference's soak.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import tier as jtier  # noqa: E402
from repro.embed import get_scheme as jscheme  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.resilience import chaos as jchaos  # noqa: E402
from repro.resilience import faults as jflt  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JConfig  # noqa: E402
from repro_torch import tier  # noqa: E402
from repro_torch.checkpoint import manager as tm  # noqa: E402
from repro_torch.embed import get_scheme  # noqa: E402
from repro_torch.optim import optimizers as opt_lib  # noqa: E402
from repro_torch.resilience import chaos  # noqa: E402
from repro_torch.resilience import faults as flt  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from test_torch_tier import _Pool, _problem  # noqa: E402

QUIET = {"log": lambda _: None}


@pytest.fixture(autouse=True)
def _uninstall():
    yield
    flt.install(None)
    jflt.install(None)


def _factory(ckpt_dir, total, ckpt_every=20, **kw):
    """A fresh (store, controller, Trainer) per call: one incarnation."""
    _, tcfg, _, ttable, _, mem, offs, raw_batch = _problem()
    scheme = get_scheme(tcfg.kind)

    def plan(batch):
        g = torch.from_numpy((batch["ids"] + offs).reshape(-1))
        return scheme.locations(tcfg, {}, g)

    def loss(model, b):
        batch, tb = tier.split_batch(b)
        e = ttable.embed_fields(dict(model.embedding), tb, batch["ids"])
        return torch.mean((e - batch["y"]) ** 2), {}

    def make(inj=None):
        st = tier.TieredStore(mem, 1024, block=128, stage_blocks=24,
                              device="cpu")
        ctrl = tier.TierController(st, raw_batch, plan, retier_every=4)
        cfg = TrainerConfig(total_steps=total,
                            ckpt_dir=str(ckpt_dir) if ckpt_dir else None,
                            ckpt_every=ckpt_every, keep=3, log_every=0,
                            ckpt_delta=True, max_consecutive_skips=1,
                            rollback_on_quarantine=True, **kw)
        return Trainer(cfg, loss, _Pool(st.initial_compact().numpy()),
                       opt_lib.adagrad(0.1), raw_batch, sparse_grads=False,
                       device="cpu", faults=inj, tier=ctrl)

    return make


def _jfactory(ckpt_dir, total, ckpt_every=20):
    """The reference's tiered Trainer on the same problem, with blocking
    saves (its rollback reads the directory without waiting for an async
    save, the port's waits)."""
    jcfg, _, jtable, _, jparams, mem, offs, raw_batch = _problem()
    scheme = jscheme(jcfg.kind)

    def jbatch(step):
        return {k: jnp.asarray(v) for k, v in raw_batch(step).items()}

    def loss(p, b):
        batch, tb = jtier.split_batch(b)
        e = jtable.embed_fields(p["embedding"], tb, batch["ids"])
        l = jnp.mean((e - batch["y"]) ** 2)
        return l, {"l": l}

    def make(inj=None):
        st = jtier.TieredStore(mem, 1024, block=128, stage_blocks=24)

        def plan(batch):
            g = (np.asarray(batch["ids"]) + offs).reshape(-1)
            return scheme.locations(jcfg, {}, jnp.asarray(g))

        ctrl = jtier.TierController(st, jbatch, plan, retier_every=4)
        params = {"embedding": dict(jparams["embedding"],
                                    memory=st.initial_compact())}
        cfg = JConfig(total_steps=total, ckpt_dir=str(ckpt_dir),
                      ckpt_every=ckpt_every, keep=3, log_every=0,
                      ckpt_delta=True, max_consecutive_skips=1,
                      rollback_on_quarantine=True, async_ckpt=False)
        return JTrainer(cfg, loss, params, jopt.adagrad(0.1), jbatch,
                        sparse_grads=False, tier=ctrl, faults=inj)

    return make


def _same(a, b):
    return chaos.states_bit_identical(chaos.durable_state(a),
                                      chaos.durable_state(b))


def test_tiered_durable_resume_parity(tmp_path):
    make = _factory(tmp_path / "ckpt", 24, ckpt_every=4)
    t1 = make(flt.FaultInjector("preempt@14"))
    out1 = t1.fit(**QUIET)
    assert out1["preempted"] and out1["step"] == 14
    t2 = make()
    out2 = t2.fit(**QUIET)
    assert out2["step"] == 24 and not out2["preempted"]
    assert out2["resumed_step"] == 14
    clean = _factory(tmp_path / "clean", 24, ckpt_every=4)()
    clean.fit(**QUIET)
    assert _same(t2, clean)
    got, want = t2.tier.tier_meta(), clean.tier.tier_meta()
    np.testing.assert_array_equal(got["hot_ids"], want["hot_ids"])
    np.testing.assert_array_equal(got["ema"].view(np.int64),
                                  want["ema"].view(np.int64))
    step = t2.mgr.latest_step()
    with open(os.path.join(tmp_path, "ckpt", f"step_{step:010d}",
                           "manifest.json")) as f:
        leaves = json.load(f)["leaves"]
    m = clean.tier.store.m
    assert leaves["params/embedding/memory"]["shape"] == [m]
    assert leaves["opt_state/embedding/memory"]["shape"] == [m]
    assert leaves["tier/hot_ids"]["dtype"] == "int32"
    assert leaves["tier/ema"]["dtype"] == "float64"
    # the restored trainer's compact tensors are the model's own
    assert t2.params["embedding.memory"] is \
        t2.model.embedding["memory"]


def test_checkpoint_without_tier_meta_drops_staged_rows(tmp_path):
    """A checkpoint of the compact pools (no ``tier`` leaves) loads into
    the live compact tensors and the zero-argument ``on_restore`` drops the
    staged rows; training then continues."""
    make = _factory(None, 6)
    t = make()
    t.fit(**QUIET)
    mgr = tm.CheckpointManager(str(tmp_path / "compact"))
    from repro_torch.train.trainer import _nested
    mgr.save(6, {"params": _nested(t.params),
                 "opt_state": _nested(t.opt_state),
                 "step": np.asarray(6, np.int32)})
    t.mgr = mgr
    assert t.tier.store._staged_ids is not None
    before = t.params["embedding.memory"].detach().clone()
    assert t.try_resume() and t.step == 6
    assert t.tier.store._staged_ids is None
    assert torch.equal(t.params["embedding.memory"], before)
    t.cfg.total_steps = 8
    assert t.fit(**QUIET)["step"] == 8


def test_rollback_while_tiered_drops_staged_rows(tmp_path):
    make = _factory(tmp_path / "ckpt", 16, ckpt_every=4)
    t = make(flt.FaultInjector("nan_grad@9"))
    out = t.fit(**QUIET)
    assert out["step"] == 16 and not out["preempted"]
    assert out["skipped_steps"] == 1 and out["rollbacks"] == 1
    assert out["resumed_step"] == 8
    clean = _factory(tmp_path / "clean", 16, ckpt_every=4)()
    clean.fit(**QUIET)
    assert _same(t, clean)


def test_stage_fail_retries_and_stays_invisible():
    t = _factory(None, 12)(flt.FaultInjector("stage_fail@3"))
    out = t.fit(**QUIET)
    assert out["step"] == 12
    assert t.tier.store.stats["stage_retries"] == 1
    clean = _factory(None, 12)()
    clean.fit(**QUIET)
    assert _same(t, clean)
    assert out["skipped_steps"] == 0 and out["rollbacks"] == 0


def test_stage_fail_raises_before_any_copy():
    _, _, _, _, _, mem, _, _ = _problem()
    st = tier.TieredStore(mem, 1024, block=128, stage_blocks=24,
                          device="cpu")
    flt.install(flt.FaultInjector("stage_fail@0"))
    with pytest.raises(tier.StageTransferError):
        st.stage(np.array([20, 21]))
    assert st._pending_ids is None and st.stats["stage_steps"] == 0
    assert st.stage(np.array([20, 21]))["staged"] == 2


def test_chaos_soak_tiered(tmp_path):
    """200 steps under the reference's seed-16 schedule of all five
    transient faults: completes, loses at most ``ckpt_every`` steps a
    restart, ends bit-identical to the clean tiered run; every
    incarnation's counters and the final result equal the reference's
    tiered soak (the loss within 1e-6)."""
    total, every = 200, 20
    spec = chaos.make_schedule(total, seed=16, kinds=chaos.SOAK_KINDS,
                               min_step=every + 1)
    assert spec == jchaos.make_schedule(total, seed=16,
                                        kinds=jchaos.SOAK_KINDS,
                                        min_step=every + 1)
    assert {tok.split("@")[0] for tok in spec.split(",")} == set(
        chaos.SOAK_KINDS)
    made, jmade = [], []

    def factory(inj):
        made.append(_factory(tmp_path / "ckpt", total, every)(inj))
        return made[-1]

    def jfactory(inj):
        jmade.append(_jfactory(tmp_path / "jckpt", total, every)(inj))
        return jmade[-1]

    res = chaos.run_chaos(factory, spec, seed=16)
    assert res["step"] == total and not res["preempted"]
    assert res["chaos_max_lost_steps"] <= every
    assert res["chaos_restarts"] == spec.count("preempt@")
    assert res["last_durable_step"] == total
    assert res["tier_hot_rows"] == 1024
    assert made[-1].tier.store.stats["stage_retries"] + sum(
        t.tier.store.stats["stage_retries"] for t in made[:-1]) == 1
    clean = _factory(tmp_path / "clean", total, every)()
    clean.fit(**QUIET)
    assert _same(made[-1], clean)
    jres = jchaos.run_chaos(jfactory, spec, seed=16)
    timed = ("straggler_steps", "steps_per_sec", "lookups_per_sec")
    for k, v in jres.items():
        if k == "loss":
            np.testing.assert_allclose(res[k], v, rtol=1e-6)
        elif k not in timed:
            assert res[k] == v, k
    assert len(made) == len(jmade)
    for t, j in zip(made, jmade):
        tc, jc = t.health.as_dict(), j.health.as_dict()
        tc.pop("straggler_steps"), jc.pop("straggler_steps")
        assert tc == jc
        assert t.tier.store.stats == j.tier.store.stats
