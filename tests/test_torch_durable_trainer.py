"""The port's Trainer with durability (checkpoints, resume, preemption, the
guard's rollback, pool integrity, the chaos soak) against the reference's
(``repro.train.trainer``), and Trainer states across the two packages.

- Resume and preemption: bit-identical to an uninterrupted run, over
  incremental checkpoints.
- Rollback after consecutive skips heals to the clean run's bits; it backs
  off, and gives up loudly.
- Bit-rot: the boundary scan quarantines it, or with
  ``rollback_on_quarantine`` restores the true bytes.
- A chaos soak of 48 steps ends bit-identical to the port's clean run;
  under the same fault spec the health counters equal the reference
  Trainer's (the straggler count is the host clock's) and the final loss is
  within 1e-6 of it.
- A reference Trainer's checkpoint resumes in the port's Trainer through
  ``state_from_jax``, and the reverse through ``state_to_jax``.
- Checkpoints under a mesh of gloo ranks: a (1, 4) save byte-identical to
  the one-process save; its checkpoint resumed at (2, 2), at (1, 2) and on
  one process, and the reference's on 4 ranks, each ending bit-identical to
  the run it continues; a chaos soak on 4 ranks bit-identical to its clean
  run.
- The launcher's durability flags on the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal as signal_mod
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as jm  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.embed import EmbeddingTable as JTable  # noqa: E402
from repro.embed import get_scheme as jscheme  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.resilience import chaos as jchaos  # noqa: E402
from repro.resilience import faults as jflt  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JConfig  # noqa: E402
from repro_torch.checkpoint import manager as tm  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import (params_from_jax, state_from_jax,  # noqa: E402
                                 state_to_jax)
from repro_torch.embed import EmbeddingTable, get_scheme  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402
from repro_torch.optim import optimizers as opt_lib  # noqa: E402
from repro_torch.resilience import chaos  # noqa: E402
from repro_torch.resilience import faults as flt  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
import dist_ranks as dr  # noqa: E402

QUIET = {"log": lambda _: None}


@pytest.fixture(autouse=True)
def _uninstall():
    yield
    flt.install(None)
    jflt.install(None)


# ------------------------------------------- the resident CTR smoke problem
# (the reference's tests/test_durability.py::_ctr_problem, in both packages)

VOCAB, D, M = 512, 16, 4096


def _ctr_batch(step):
    Y = np.random.default_rng(1).normal(size=(VOCAB, D)).astype(np.float32)
    ids = np.random.default_rng(step).integers(0, VOCAB, (64,), np.int32)
    return {"ids": ids, "y": Y[ids]}


def _jctr(kind="hashed_row"):
    table = JTable(jscheme(kind).build_config((VOCAB,), D, M, seed=3))
    bufs = table.make_buffers(None)

    def loss_fn(params, b):
        e = table.embed(params["embedding"], bufs, 0, b["ids"])
        return jnp.mean((e - b["y"]) ** 2), {}

    def batch_fn(step):
        return {k: jnp.asarray(v) for k, v in _ctr_batch(step).items()}

    return loss_fn, batch_fn, lambda: {"embedding": table.init(
        jax.random.key(0))}


def _ctr(kind="hashed_row"):
    table = EmbeddingTable(get_scheme(kind).build_config((VOCAB,), D, M,
                                                         seed=3))
    bufs = table.make_buffers(None, device="cpu")
    init = np.asarray(_jctr(kind)[2]()["embedding"]["memory"])

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embedding = torch.nn.ParameterDict(
                {"memory": torch.from_numpy(init.copy())})

    def loss_fn(model, b):
        e = table.embed(dict(model.embedding), bufs, 0, b["ids"])
        return torch.mean((e - b["y"]) ** 2), {}

    return loss_fn, _ctr_batch, Model


def _factory(ckpt_dir, total, ckpt_every=4, **kw):
    loss_fn, batch_fn, Model = _ctr()

    def make(inj=None):
        cfg = TrainerConfig(total_steps=total, ckpt_dir=str(ckpt_dir),
                            ckpt_every=ckpt_every, keep=3, log_every=0,
                            ckpt_delta=True, max_consecutive_skips=1,
                            rollback_on_quarantine=True, **kw)
        return Trainer(cfg, loss_fn, Model(), opt_lib.adagrad(0.1),
                       batch_fn, device="cpu", faults=inj)

    return make


def _jfactory(ckpt_dir, total, ckpt_every=4, **kw):
    """The reference's Trainer on the same problem.  Its saves are blocking:
    its rollback decisions read the directory without waiting for an async
    save (the port's wait), so with async saves its counts would depend on
    how fast the writer thread runs."""
    loss_fn, batch_fn, fresh = _jctr()

    def make(inj=None):
        cfg = JConfig(total_steps=total, ckpt_dir=str(ckpt_dir),
                      ckpt_every=ckpt_every, keep=3, log_every=0,
                      ckpt_delta=True, max_consecutive_skips=1,
                      rollback_on_quarantine=True, async_ckpt=False, **kw)
        return JTrainer(cfg, loss_fn, fresh(), jopt.adagrad(0.1), batch_fn,
                        faults=inj)

    return make


def _kinds(d):
    out = []
    for s in tm.CheckpointManager(str(d)).retained_steps():
        with open(os.path.join(d, f"step_{s:010d}", "manifest.json")) as f:
            out.append(json.load(f)["kind"])
    return out


def test_preempt_and_resume_over_deltas_is_bit_identical(tmp_path):
    make = _factory(tmp_path / "ckpt", 24)
    t1 = make()
    t1.faults = flt.FaultInjector("preempt@13")
    out1 = t1.fit(**QUIET)
    assert out1["preempted"] and out1["step"] == 13
    t2 = make()
    out2 = t2.fit(**QUIET)
    assert out2["step"] == 24 and not out2["preempted"]
    assert out2["resumed_step"] == 13
    clean = _factory(tmp_path / "clean", 24)()
    clean.fit(**QUIET)
    assert chaos.states_bit_identical(chaos.durable_state(t2),
                                      chaos.durable_state(clean))
    assert "delta" in _kinds(tmp_path / "ckpt")
    # the model itself trains the restored bytes (copied into its tensors)
    assert t2.params["embedding.memory"] is t2.model.embedding["memory"]


def test_durability_health_fields_and_unified_result(tmp_path):
    out = _factory(tmp_path, 12)().fit(**QUIET)
    assert out["last_durable_step"] == 12 and out["ckpt_bytes_written"] > 0
    assert out["delta_chain_len"] >= 1 and out["torn_writes_detected"] == 0
    assert out["resumed_step"] is None and out["skipped_steps"] == 0
    pre = _factory(tmp_path / "p", 50)(flt.FaultInjector("preempt@3")).fit(
        **QUIET)
    assert pre["preempted"] and set(pre) == set(out)
    jout = _jfactory(tmp_path / "j", 12)().fit(**QUIET)
    assert set(out) == set(jout) | {"sparse_grads", "batch_sec"}
    for k in ("last_durable_step", "ckpt_bytes_written", "delta_chain_len"):
        assert out[k] == jout[k], k


def _linear(steps, faults=None, ckpt_dir=None, **kw):
    w_true = np.random.default_rng(0).normal(0, 1, (8, 1)).astype(np.float32)

    def batch_fn(step):
        x = np.random.default_rng(step).normal(0, 1, (32, 8)).astype(
            np.float32)
        return {"x": x, "y": x @ w_true}

    class Lin(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros((8, 1)))

    def loss_fn(m, b):
        return torch.mean((b["x"] @ m.w - b["y"]) ** 2), {}

    cfg = TrainerConfig(total_steps=steps, log_every=0, ckpt_dir=ckpt_dir,
                        **kw)
    return Trainer(cfg, loss_fn, Lin(), opt_lib.adam(5e-2), batch_fn,
                   device="cpu",
                   faults=flt.FaultInjector(faults) if faults else None)


def test_rollback_restores_and_recovers_bit_exact(tmp_path):
    t = _linear(10, "nan_grad@4,nan_grad@5", str(tmp_path / "a"),
                ckpt_every=2, max_consecutive_skips=2, rollback_backoff=0.01)
    out = t.fit(**QUIET)
    assert out["rollbacks"] == 1 and out["retries"] >= 1
    assert out["skipped_steps"] == 2 and out["step"] == 10
    clean = _linear(10, ckpt_dir=str(tmp_path / "b"), ckpt_every=2)
    clean.fit(**QUIET)
    assert chaos.states_bit_identical(chaos.durable_state(t),
                                      chaos.durable_state(clean))
    assert t.opt_state.step == clean.opt_state.step == 10


def test_rollback_gives_up_loudly_and_backs_off_boundedly():
    t = _linear(10, "nan_grad@1,nan_grad@2", max_consecutive_skips=1,
                max_rollbacks=1, rollback_backoff=0.0)
    with pytest.raises(RuntimeError, match="giving up"):
        t.fit(**QUIET)
    assert t.health.rollbacks == 2
    cfg = TrainerConfig(1, rollback_backoff=0.05, rollback_backoff_max=0.2)
    delays = [min(cfg.rollback_backoff * 2 ** k, cfg.rollback_backoff_max)
              for k in range(10)]
    assert delays[0] == 0.05 and max(delays) == 0.2


def test_slow_rank_fault_counts_straggler():
    t = _linear(24, "slow_rank@20:0.3")
    t.fit(**QUIET)
    assert t.straggler_steps == t.health.straggler_steps >= 1


def test_second_sigint_restores_default_handler():
    t = _linear(1)
    orig = {s: signal_mod.getsignal(s) for s in (signal_mod.SIGINT,
                                                 signal_mod.SIGTERM)}
    try:
        t.install_signal_handlers()
        handler = signal_mod.getsignal(signal_mod.SIGINT)
        handler(signal_mod.SIGINT, None)
        assert t._preempted
        assert signal_mod.getsignal(signal_mod.SIGINT) is handler
        handler(signal_mod.SIGINT, None)
        assert signal_mod.getsignal(signal_mod.SIGINT) is signal_mod.SIG_DFL
    finally:
        for s, h in orig.items():
            signal_mod.signal(s, h)


def test_try_resume_waits_for_inflight_async_save(tmp_path):
    t = _linear(5, ckpt_dir=str(tmp_path))
    t.fit(**QUIET)
    t.step = 7
    real_write = t.mgr._write

    def slow_write(step, host, *a):
        time.sleep(0.3)
        real_write(step, host, *a)

    t.mgr._write = slow_write
    t.save(blocking=False)
    t2 = _linear(9, ckpt_dir=str(tmp_path))
    t2.mgr = t.mgr
    assert t2.try_resume() and t2.step == 7


def test_rot_row_is_quarantined_at_the_boundary():
    loss_fn, batch_fn, Model = _ctr()
    t = Trainer(TrainerConfig(total_steps=10, log_every=0, ckpt_every=4,
                              max_consecutive_skips=50),
                loss_fn, Model(), opt_lib.adagrad(0.1), batch_fn,
                device="cpu", faults=flt.FaultInjector("rot_row@5:4"))
    out = t.fit(**QUIET)
    assert out["step"] == 10 and out["quarantined_chunks"] >= 1
    mem = t.params["embedding.memory"].detach()
    assert torch.isfinite(mem).all() and mem.abs().max() <= 1e30


@pytest.mark.parametrize("seed,path", [(1, "quarantine"), (0, "skip")])
def test_rot_before_a_boundary_rolls_back_to_true_bytes(tmp_path, seed,
                                                         path):
    """Bit-rot one step before a boundary: either the step reads a rotten
    slot (a skip, then a rollback) or the boundary scan finds it
    (``rollback_on_quarantine``); both restore the checkpoint's true bytes
    and end bit-identical to the clean run, with the reference's counts."""
    spec = "rot_row@7:2"
    t = _factory(tmp_path / "a", 12)(flt.FaultInjector(spec, seed))
    out = t.fit(**QUIET)
    assert out["rollbacks"] == 1
    assert (out["quarantined_chunks"] >= 1) == (path == "quarantine")
    assert (out["skipped_steps"] == 1) == (path == "skip")
    clean = _factory(tmp_path / "b", 12)()
    clean.fit(**QUIET)
    assert chaos.states_bit_identical(chaos.durable_state(t),
                                      chaos.durable_state(clean))
    jout = _jfactory(tmp_path / "j", 12)(jflt.FaultInjector(spec, seed)).fit(
        **QUIET)
    for k in ("rollbacks", "quarantined_chunks", "skipped_steps",
              "nonfinite_grads", "retries", "ckpt_bytes_written"):
        assert out[k] == jout[k], k


def test_restore_sanitizes_pool_and_accumulator(tmp_path):
    loss_fn, batch_fn, Model = _ctr()
    cfg = TrainerConfig(total_steps=4, log_every=0, ckpt_dir=str(tmp_path),
                        ckpt_every=2)
    Trainer(cfg, loss_fn, Model(), opt_lib.adagrad(0.1), batch_fn,
            device="cpu").fit(**QUIET)
    step_dir = os.path.join(str(tmp_path), "step_0000000004")
    p = os.path.join(step_dir, "arrays.npz")
    with np.load(p) as z:
        host = {k: z[k].copy() for k in z.files}
    keys = [k for k in host if k.endswith("memory")]
    assert sorted(keys) == ["opt_state/embedding/memory",
                            "params/embedding/memory"]
    for k in keys:
        host[k][3] = np.float32("nan")
    np.savez(p, **host)
    mpath = os.path.join(step_dir, "manifest.json")
    with open(mpath) as f:
        man = json.load(f)
    man["checksum"] = tm._tree_digest(host)
    for k in keys:
        man["leaves"][k]["sha256"] = tm._leaf_sha(host[k])
        man["integrity"][k]["checksums"] = [
            int(c) for c in tm.integ_lib.np_chunk_checksums(host[k])]
    with open(mpath, "w") as f:
        json.dump(man, f)
    t2 = Trainer(cfg, loss_fn, Model(), opt_lib.adagrad(0.1), batch_fn,
                 device="cpu")
    assert t2.try_resume() and t2.health.quarantined_chunks == 2
    assert torch.isfinite(t2.params["embedding.memory"]).all()
    assert torch.isfinite(t2.opt_state["embedding.memory"]).all()


# ------------------------------------------------ checkpoints under a mesh
# The CTR problem on gloo ranks (``dist_ranks.ckpt_mesh`` / ``ckpt_resume``:
# the same problem, built without JAX): a (1, 4) run saves at step 4 and
# goes on to 8; the step-4 checkpoint resumes at (2, 2), at (1, 2) and on
# one process; the reference's checkpoint resumes on 4 ranks; a chaos soak
# runs on 4 ranks.


def _whole(ranks, P):
    """Whole arrays from the first P ranks' states (data index 0): pool
    slabs concatenated, every other leaf as rank 0 holds it."""
    out = {}
    for k, v in ranks[0].items():
        out[k] = (np.concatenate([r[k] for r in ranks[:P]])
                  if "memory" in k.split("/") and np.ndim(v) else v)
    return out


def _assert_states_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.fixture(scope="module")
def mesh_ckpt(tmp_path_factory):
    import shutil

    from repro_torch.dist.collectives import run_ranks

    root = tmp_path_factory.mktemp("mesh_ckpt")
    init = np.asarray(_jctr()[2]()["embedding"]["memory"])
    jdir = str(root / "jax")
    _jfactory(jdir, 4)().fit(**QUIET)           # the reference saves step 4
    for name in ("jax_ranks", "jax_one", "jax_ref"):
        shutil.copytree(jdir, str(root / name))
    spec = chaos.make_schedule(24, seed=21, kinds=SOAK_KINDS, n_faults=5,
                               min_step=5)
    r14 = root / "r14"
    a = run_ranks(dr.ckpt_mesh, 4, init, str(r14), str(root / "jax_ranks"),
                  spec, device="cpu")
    for name in ("at4_22", "at4_12", "at4_one"):
        shutil.copytree(str(r14 / "at4"), str(root / name))
    b = run_ranks(dr.ckpt_resume, 4, init, str(root / "at4_22"), 8, data=2,
                  device="cpu")
    c = run_ranks(dr.ckpt_resume, 2, init, str(root / "at4_12"), 8,
                  device="cpu")
    one = dr.ckpt_resume(None, init, str(root / "at4_one"), 8)
    return {"root": root, "init": init, "spec": spec, "a": a,
            "resumed": {"(2, 2)": (b, 2), "(1, 2)": (c, 2),
                        "one process": ([one], 1)}}


def test_mesh_save_is_byte_identical_to_one_process(mesh_ckpt, tmp_path):
    """A (1, 4) save (the pool and its accumulator gathered, written by
    rank 0) is the one-process save of the same state, file for file."""
    t = _factory(tmp_path / "one", 4)()
    t.fit(**QUIET)
    for f in ("manifest.json", "arrays.npz"):
        got = (mesh_ckpt["root"] / "r14" / "at4" / "step_0000000004" / f
               ).read_bytes()
        want = (tmp_path / "one" / "step_0000000004" / f).read_bytes()
        assert got == want, f


@pytest.mark.parametrize("where", ["(2, 2)", "(1, 2)", "one process"])
def test_mesh_checkpoint_resumes_elastically(mesh_ckpt, where):
    """The (1, 4) step-4 checkpoint resumed at another mesh (or on one
    process) ends bit-identical to the uninterrupted (1, 4) run."""
    ranks, P = mesh_ckpt["resumed"][where]
    want = _whole([r["uninterrupted"] for r in mesh_ckpt["a"]], 4)
    for r in ranks:
        assert r["resumed"] == 4 and r["step"] == 8
    _assert_states_equal(_whole([r["state"] for r in ranks], P), want)
    if where == "(2, 2)":
        for d in range(P):                        # replicas bit-equal
            _assert_states_equal(ranks[d]["state"], ranks[P + d]["state"])


def test_reference_checkpoint_resumes_on_four_ranks(mesh_ckpt):
    """The reference Trainer's step-4 checkpoint resumes on 4 ranks: the
    end state bit-identical to the port's one-process resume of it, and
    within 1e-6 of the reference continuing itself."""
    root, init = mesh_ckpt["root"], mesh_ckpt["init"]
    ranks = [r["jax"] for r in mesh_ckpt["a"]]
    assert all(r["resumed"] == 4 and r["step"] == 8 for r in ranks)
    got = _whole([r["state"] for r in ranks], 4)
    _assert_states_equal(got, dr.ckpt_resume(None, init, str(root / "jax_one"),
                                             8)["state"])
    jt = _jfactory(str(root / "jax_ref"), 8)()
    jt.fit(**QUIET)
    want = jm._flatten(jax.tree_util.tree_map(np.asarray, jt._state()))
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_chaos_soak_on_four_ranks_ends_bit_identical(mesh_ckpt):
    """24 steps on a (1, 4) mesh under the same fault schedule on every rank
    (a preemption, a torn save, pool rot, a NaN gradient): every rank's
    durable state bit-identical to its clean run's."""
    spec = mesh_ckpt["spec"]
    assert {t.split("@")[0] for t in spec.split(",")} == set(SOAK_KINDS)
    for r in mesh_ckpt["a"]:
        ch = r["chaos"]
        assert ch["res"]["step"] == 24 and not ch["res"]["preempted"]
        assert ch["incarnations"] == spec.count("preempt@") + 1
        assert ch["res"]["chaos_max_lost_steps"] <= 4
        assert chaos.states_bit_identical(ch["state"], ch["clean"])
    agreed = ("skipped_steps", "rollbacks", "torn_writes_detected",
              "quarantined_chunks", "chaos_restarts", "loss")
    for r in mesh_ckpt["a"][1:]:
        for k in agreed:
            assert r["chaos"]["res"][k] == mesh_ckpt["a"][0]["chaos"]["res"][k]


# ------------------------------------------------------------- chaos soak

SOAK_KINDS = ("preempt", "torn_ckpt", "rot_row", "nan_grad")


def test_chaos_soak_bit_identical_and_matches_reference(tmp_path):
    total, every = 48, 8
    spec = chaos.make_schedule(total, seed=21, kinds=SOAK_KINDS, n_faults=5,
                               min_step=every + 1)
    assert {t.split("@")[0] for t in spec.split(",")} == set(SOAK_KINDS)
    made = []

    def factory(inj):
        made.append(_factory(tmp_path / "ckpt", total, every)(inj))
        return made[-1]

    res = chaos.run_chaos(factory, spec, seed=21)
    assert res["step"] == total and not res["preempted"]
    assert res["chaos_max_lost_steps"] <= every
    assert res["chaos_restarts"] == spec.count("preempt@")
    assert res["last_durable_step"] == total
    clean = _factory(tmp_path / "clean", total, every)()
    clean.fit(**QUIET)
    assert chaos.states_bit_identical(chaos.durable_state(made[-1]),
                                      chaos.durable_state(clean))
    jmade = []

    def jfactory(inj):
        jmade.append(_jfactory(tmp_path / "jckpt", total, every)(inj))
        return jmade[-1]

    jres = jchaos.run_chaos(jfactory, spec, seed=21)
    timed = ("straggler_steps", "steps_per_sec", "lookups_per_sec")
    for k, v in jres.items():
        if k == "loss":
            np.testing.assert_allclose(res[k], v, rtol=1e-6)
        elif k not in timed:
            assert res[k] == v, k
    # every incarnation's counters, not only the last one's: the schedule
    # (one preempt) skips two steps, quarantines rot at a boundary, reads
    # past a torn save and rolls back three times
    assert len(made) == len(jmade) == 2
    for t, j in zip(made, jmade):
        tc, jc = t.health.as_dict(), j.health.as_dict()
        tc.pop("straggler_steps"), jc.pop("straggler_steps")
        assert tc == jc
    total_of = {k: sum(getattr(t.health, k) for t in made)
                for k in ("skipped_steps", "rollbacks",
                          "torn_writes_detected", "quarantined_chunks")}
    assert total_of["skipped_steps"] == 2 and total_of["rollbacks"] == 3
    assert total_of["torn_writes_detected"] == 1
    assert total_of["quarantined_chunks"] >= 1


# ---------------------------------------------- states across the packages

def _smoke(optimizer="adagrad"):
    arch_j = dataclasses.replace(jget("dlrm-rm2"), optimizer=optimizer)
    arch_t = dataclasses.replace(tget("dlrm-rm2"), optimizer=optimizer)
    jcfg, tcfg = arch_j.make_smoke(), arch_t.make_smoke()
    _, _, jbatch, jloss = jlaunch._recsys_setup(arch_j, jcfg, 300, 32)
    _, _, tbatch, tloss = tlaunch._recsys_setup(arch_t, tcfg, 300, 32, "cpu")
    jparams = jrec.init(jax.random.key(0), jcfg)
    model = trec.init(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu"))
    return (arch_j, jloss, jbatch, jparams), (arch_t, tloss, tbatch, model)


def _pair(jpart, tpart, multi, jdir=None, tdir=None, steps=0):
    arch_j, jloss, jbatch, jparams = jpart
    arch_t, tloss, tbatch, model = tpart
    jo = jlaunch.make_optimizer(arch_j) if multi else jopt.adagrad(0.05)
    to = tlaunch.make_optimizer(arch_t) if multi else opt_lib.adagrad(0.05)
    jt = JTrainer(JConfig(total_steps=steps, log_every=0, ckpt_dir=jdir,
                          ckpt_every=1000), jloss, jparams, jo, jbatch)
    tt = Trainer(TrainerConfig(total_steps=steps, log_every=0, ckpt_dir=tdir,
                               ckpt_every=1000), tloss, model, to, tbatch,
                 device="cpu")
    return jt, tt


@pytest.mark.parametrize("optimizer,multi", [("adagrad", True),
                                             ("adam", True), ("sgd", True),
                                             ("adagrad", False)])
def test_state_to_jax_is_the_reference_state(optimizer, multi, tmp_path):
    jt, tt = _pair(*_smoke(optimizer), multi)
    want = jm._flatten(jax.tree_util.tree_map(np.asarray, jt._state()))
    got = tm._flatten(state_to_jax(tt._state(), multi=multi))
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    back = tm._flatten(state_from_jax(jm._unflatten(want), multi=multi))
    mine = tm._flatten(tt._state())
    assert set(back) == set(mine)
    for k in mine:
        np.testing.assert_array_equal(back[k], tm._host(mine[k]), err_msg=k)
    if not multi:
        # the same model, the same optimizer tree: the same pool leaves
        jm.CheckpointManager(str(tmp_path / "j")).save(0, jt._state())
        tt.mgr = tm.CheckpointManager(str(tmp_path / "t"))
        tt.save()
        man = [json.load(open(os.path.join(tmp_path, d, "step_0000000000",
                                           "manifest.json")))
               for d in ("j", "t")]
        assert set(man[0]["integrity"]) == set(man[1]["integrity"]) == {
            "params/embedding/memory", "opt_state/embedding/memory"}


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_resumes_across_packages(direction, tmp_path):
    """Three steps in one package, a checkpoint, the state carried across
    and saved for the other package's Trainer, which resumes and takes two
    more steps: losses within 1e-5 of the first package continuing (the
    tolerance of test_torch_train.py's smoke trainers)."""
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jt, tt = _pair(*_smoke("adagrad"), True, jdir, tdir, steps=3)
    src = jt if direction == "jax_to_torch" else tt
    src.fit(**QUIET)                       # saves step 3 at the end
    if direction == "jax_to_torch":
        step, tree = tm.CheckpointManager(jdir).restore()
        tm.CheckpointManager(tdir).save(step, state_from_jax(tree))
        dst = tt
    else:
        step, tree = jm.CheckpointManager(tdir).restore()
        jm.CheckpointManager(jdir).save(step, state_to_jax(tree))
        dst = jt
    assert step == 3
    losses = []
    for t in (src, dst):
        t.cfg.total_steps = 5
        out = t.fit(**QUIET)
        assert out["step"] == 5
        losses.append(out["loss"])
    assert dst._resumed_step == 3
    np.testing.assert_allclose(losses[1], losses[0], rtol=0, atol=1e-5)


# --------------------------------------------------------------- launcher

def test_launcher_durability_flags_on_the_cpu(tmp_path):
    ck = str(tmp_path / "ck")
    # hashed_elem: the same flags without the CPU's plain minhash
    base = ["--device", "cpu", "--smoke", "--embedding-kind", "hashed_elem",
            "--batch", "32", "--eval-batches", "1", "--ckpt-dir", ck,
            "--ckpt-delta"]
    before = signal_mod.getsignal(signal_mod.SIGTERM)
    out = tlaunch.main(base + ["--steps", "6", "--faults",
                               "nan_grad@2,rot_row@3:4", "--fault-seed", "3"])
    tr = out["train"]
    assert tr["step"] == 6 and tr["skipped_steps"] >= 1
    assert tr["last_durable_step"] == 6 and out["health"]["skipped_steps"] \
        == tr["skipped_steps"]
    # the run's signal handlers are the run's only
    assert signal_mod.getsignal(signal_mod.SIGTERM) is before
    again = tlaunch.main(base + ["--steps", "8", "--no-guard",
                                 "--ckpt-compact-every", "2"])["train"]
    assert again["resumed_step"] == 6 and again["step"] == 8
    assert not again["guard_enabled"]
    assert _kinds(ck)[-1] == "delta"
