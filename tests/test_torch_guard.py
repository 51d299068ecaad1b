"""The guarded train step (``repro_torch.resilience.guard``) against the
reference's (``repro.resilience.guard``).

- A skipped step (nan, inf and huge gradients) leaves the parameters and
  every optimizer moment bit-unchanged: dense Adam on a linear problem, and
  the sparse path (a bucketed SparseGrad of a striped LMA pool, Adagrad)
  and the dense pool gradient of the same pool.
- A clean guarded step is bit-identical to an unguarded one.
- Skip counts equal the reference Trainer's under the same faults, and the
  losses stay within 1e-6 of it; the ``REPRO_GUARD_STEP`` gate.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.optim import optimizers as jopt  # noqa: E402
from repro.resilience import faults as jflt  # noqa: E402
from repro.resilience import guard as jguard  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JConfig  # noqa: E402
from repro_torch.core.signatures import synthetic_dense_store  # noqa: E402
from repro_torch.embed import EmbeddingTable, get_scheme  # noqa: E402
from repro_torch.optim import optimizers as opt_lib  # noqa: E402
from repro_torch.resilience import faults as flt  # noqa: E402
from repro_torch.resilience import guard as guard_lib  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


@pytest.fixture(autouse=True)
def _uninstall():
    yield
    flt.install(None)
    jflt.install(None)


def _batches(step):
    w_true = np.random.default_rng(0).normal(0, 1, (8, 1)).astype(np.float32)
    r = np.random.default_rng(step)
    x = r.normal(0, 1, (32, 8)).astype(np.float32)
    return {"x": x, "y": x @ w_true}


class _Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros((8, 1)))


def _linear_loss(model, b):
    loss = torch.mean((b["x"] @ model.w - b["y"]) ** 2)
    return loss, {}


def _trainer(steps, faults=None, **kw):
    cfg = TrainerConfig(total_steps=steps, log_every=0, **kw)
    inj = flt.FaultInjector(faults) if faults else None
    return Trainer(cfg, _linear_loss, _Linear(), opt_lib.adam(5e-2),
                   _batches, device="cpu", faults=inj)


def _jtrainer(steps, faults=None, **kw):
    def loss_fn(p, b):
        loss = jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)
        return loss, {}

    def batch_fn(step):
        return {k: jnp.asarray(v) for k, v in _batches(step).items()}

    inj = jflt.FaultInjector(faults) if faults else None
    return JTrainer(JConfig(total_steps=steps, log_every=0, **kw), loss_fn,
                    {"w": jnp.zeros((8, 1), jnp.float32)}, jopt.adam(5e-2),
                    batch_fn, faults=inj)


def _state_bits(t) -> dict:
    from repro_torch.resilience.chaos import durable_state
    return durable_state(t)


def _same(a, b):
    from repro_torch.resilience.chaos import states_bit_identical
    assert states_bit_identical(_state_bits(a), _state_bits(b))


@pytest.mark.parametrize("fault", ["nan_grad", "inf_grad", "huge_grad"])
def test_skipped_step_is_bit_exact_noop(fault):
    clean = _trainer(2)
    clean.fit(log=lambda _: None)
    faulted = _trainer(3, faults=f"{fault}@2")
    out = faulted.fit(log=lambda _: None)
    assert out["step"] == 3
    assert out["skipped_steps"] == 1 and out["nonfinite_grads"] == 1
    _same(clean, faulted)
    assert faulted.opt_state.step == clean.opt_state.step == 2


def _pool_problem(kind="lma", m=32768, d=16, vocab=512):
    scheme = get_scheme(kind)
    table = EmbeddingTable(scheme.build_config((vocab,), d, m, seed=3))
    bufs = (table.make_buffers(synthetic_dense_store(vocab, 64, max_set=16,
                                                     seed=2, device="cpu"))
            if scheme.buffer_source == "signatures" else {})
    Y = np.random.default_rng(1).normal(size=(vocab, d)).astype(np.float32)

    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embedding = torch.nn.ParameterDict(table.init(
                torch.Generator().manual_seed(0), device="cpu"))

    def batch_fn(step):
        ids = np.random.default_rng(step).integers(0, vocab, (64,),
                                                   np.int32)
        return {"ids": ids, "y": Y[ids]}

    def loss_fn(model, b):
        e = table.embed(dict(model.embedding), bufs, 0, b["ids"])
        return torch.mean((e - b["y"]) ** 2), {}

    return loss_fn, batch_fn, Model


@pytest.mark.parametrize("sparse", [True, False])
def test_skipped_step_pool_bit_exact(sparse):
    loss_fn, batch_fn, Model = _pool_problem()

    def run(steps, faults=None):
        t = Trainer(TrainerConfig(total_steps=steps, log_every=0), loss_fn,
                    Model(), opt_lib.adagrad(0.1), batch_fn,
                    sparse_grads=sparse, device="cpu",
                    faults=flt.FaultInjector(faults) if faults else None)
        t.fit(log=lambda _: None)
        return t

    clean, faulted = run(3), run(4, "nan_grad@3")
    assert faulted.health.skipped_steps == 1
    _same(clean, faulted)


@pytest.mark.parametrize("sparse", [True, False])
def test_clean_guarded_step_equals_unguarded(sparse):
    loss_fn, batch_fn, Model = _pool_problem()
    runs = []
    for guard in (True, False):
        t = Trainer(TrainerConfig(total_steps=4, log_every=0,
                                  guard_step=guard),
                    loss_fn, Model(), opt_lib.adagrad(0.1), batch_fn,
                    sparse_grads=sparse, device="cpu")
        out = t.fit(log=lambda _: None)
        assert out["guard_enabled"] is guard
        runs.append(t)
    _same(*runs)
    lin = [_trainer(5, guard_step=g) for g in (True, False)]
    for t in lin:
        t.fit(log=lambda _: None)
    _same(*lin)


def test_huge_grad_caught_by_magnitude_bound():
    t = _trainer(3, faults="huge_grad@1")
    t.fit(log=lambda _: None)
    assert t.health.skipped_steps == 1
    assert torch.isfinite(t.params["w"]).all()


def test_skip_is_independent_of_poison_value():
    a, b = _trainer(10, faults="nan_grad@4"), _trainer(10, faults="inf_grad@4")
    a.fit(log=lambda _: None)
    b.fit(log=lambda _: None)
    _same(a, b)


def test_unguarded_step_applies_poison():
    t = _trainer(3, faults="nan_grad@1", guard_step=False)
    t.fit(log=lambda _: None)
    assert t.health.skipped_steps == 0
    assert not torch.isfinite(t.params["w"]).all()


@pytest.mark.parametrize("faults", ["nan_grad@3", "inf_grad@0,huge_grad@5",
                                    "huge_grad@2,nan_grad@3,nan_grad@9"])
def test_skips_and_losses_match_reference(faults):
    """The same faults skip the same steps; every step's loss within 1e-6
    of it, relative (an ulp or two: the reference's jitted step contracts
    multiply-adds)."""
    t, j = _trainer(0, faults=faults), _jtrainer(0, faults=faults)
    for s in range(1, 13):
        t.cfg.total_steps = j.cfg.total_steps = s
        tl = t.fit(log=lambda _: None)["loss"]
        jl = j.fit(log=lambda _: None)["loss"]
        np.testing.assert_allclose(tl, jl, rtol=1e-6, atol=1e-6,
                                   err_msg=f"step {s}")
    for k in ("skipped_steps", "nonfinite_grads"):
        assert getattr(t.health, k) == getattr(j.health, k), k
    np.testing.assert_allclose(t.params["w"].detach().numpy(),
                               np.asarray(j.params["w"]), rtol=0, atol=1e-6)


def test_all_finite_and_touched_indices():
    from repro_torch.optim.sparse import SparseGrad

    sg = SparseGrad(torch.tensor([1, 5], dtype=torch.int32),
                    torch.tensor([1.0, 2.0]), (8,))
    grads = {"a": torch.ones(3), "b": sg, "c": torch.arange(3)}
    assert bool(guard_lib.all_finite(grads, 1e18))
    assert not bool(guard_lib.all_finite(grads, 1.5))
    assert not bool(guard_lib.all_finite(
        guard_lib.scale_grads(grads, float("nan"))))
    for bad in (float("nan"), float("inf"), -float("inf"), 2e18):
        for at in (0, 2):
            g = torch.ones(3)
            g[at] = bad
            assert not bool(guard_lib.all_finite({"g": g}, 1e18)), (bad, at)
    assert not bool(guard_lib.all_finite({"g": torch.tensor([1.0, -2e18])},
                                         1e18))
    assert bool(guard_lib.all_finite({"g": torch.tensor([1.0, -2e18])}))
    assert not bool(guard_lib.all_finite({"g": torch.tensor([1.0,
                                                             -float("inf")])}))
    assert bool(guard_lib.all_finite({"e": torch.zeros(0)}, 1.0))
    assert guard_lib.touched_indices(grads).tolist() == [1, 5]
    assert guard_lib.touched_indices({"a": torch.ones(2)}).numel() == 0
    assert bool(guard_lib.all_finite({}))


def test_guard_env_gate(monkeypatch):
    monkeypatch.setenv("REPRO_GUARD_STEP", "0")
    assert not guard_lib.guard_enabled() and not jguard.guard_enabled()
    assert _trainer(1).guard is False
    monkeypatch.setenv("REPRO_GUARD_STEP", "1")
    assert guard_lib.guard_enabled()
    assert _trainer(1).guard is True
