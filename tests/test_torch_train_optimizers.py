"""dlrm-rm2's smoke config trained through both packages' Trainers with the
two optimizers the reference's ``make_optimizer`` builds besides Adagrad:
``sgd`` (momentum SGD 0.9, the pool on lazy sparse SGD) and ``adam`` (Adam,
the pool on lazy row-wise Adam), each obtained as the reference obtains it,
``make_optimizer(dataclasses.replace(get_config("dlrm-rm2"), optimizer=...))``.
For lma (striped: a bucketed SparseGrad, flat states) and hashed_row (a
row-mode SparseGrad, the states viewed [m // d, d]), 5 steps from the same
parameters (``params_from_jax``) and batches: per-step losses within 1e-5,
final parameters and optimizer states within 1e-5 (the tolerance of
``test_torch_train.py``: float32 matmuls and sums in another order, and the
reference's jitted step contracts some multiply-adds).

One exception, Adam's own: an element whose gradient is near eps (1e-8) at
some step, where ``sqrt(nu / bc2)`` is above 0 and below 100 eps, gets an
update ``-lr g / (|g| + eps)`` that turns a gradient's rounding into up to
``lr / (4 eps)`` times as much parameter change (measured: a top-MLP weight
whose first gradient was 9.92e-10 in one package and 9.98e-10 in the other
moved 1.46e-5 apart).  An element is marked at each step where the
reference's nu puts it there, and is held to ``1e-5 + 2 lr`` per marked
step, the most two Adam updates near the sign regime can differ by; marked
elements stay under 0.5% of every leaf (measured: at most 0.24%, the pool's
10-15 of 8,192)."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.base import get_config as jget  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import recsys as jrec  # noqa: E402
from repro.train.trainer import Trainer as JTrainer  # noqa: E402
from repro.train.trainer import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import get_config as tget  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import recsys as trec  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def _name(kp) -> tuple[str, bool]:
    """A reference tree path -> (the port's parameter name, transposed)."""
    parts = [str(getattr(k, "key", k)) for k in kp]
    if parts[-1] == "kernel":
        return ".".join(parts[:-1] + ["weight"]), True
    return ".".join(parts), False


def _arrays(state) -> list:
    """A port optimizer state's tensors, in the reference's field order."""
    if isinstance(state, torch.Tensor):
        return [state.numpy()]
    return [np.asarray(state.step)] + [t.numpy() for t in state[1:]]


@pytest.mark.parametrize("kind", ["lma", "hashed_row"])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_dlrm_smoke_trainers_agree(optimizer, kind):
    arch_j = dataclasses.replace(jget("dlrm-rm2"), optimizer=optimizer)
    arch_t = dataclasses.replace(tget("dlrm-rm2"), optimizer=optimizer)
    jcfg = arch_j.make_smoke(embedding_kind=kind)
    tcfg = arch_t.make_smoke(embedding_kind=kind)
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
    jflat, _ = jax.tree_util.tree_flatten_with_path(jt.params)
    marked = [np.zeros(np.shape(leaf), int) for _, leaf in jflat]
    for s in range(1, steps + 1):
        jt.cfg.total_steps = tt.cfg.total_steps = s
        jl = jt.fit(log=lambda _: None)["loss"]
        tl = tt.fit(log=lambda _: None)["loss"]
        np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-5,
                                   err_msg=f"step {s}")
        if optimizer == "adam":
            bc2 = 1 - 0.999 ** s
            for i, jstate in enumerate(jt.opt_state):
                nu = np.asarray(jstate.nu).reshape(marked[i].shape)
                marked[i] += (nu > 0) & (np.sqrt(nu / bc2) < 100 * 1e-8)
    assert tt.params["embedding.memory"].grad is None
    jflat, _ = jax.tree_util.tree_flatten_with_path(jt.params)  # donated
    assert len(jflat) == len(tt.params) == len(jt.opt_state)
    lr = arch_t.learning_rate
    for (kp, leaf), jstate, n in zip(jflat, jt.opt_state, marked):
        name, tr = _name(kp)
        want, got = np.asarray(leaf), tt.params[name].detach().numpy()
        if tr:
            want, n = want.T, n.T
        assert (n > 0).mean() < 5e-3, (name, (n > 0).mean())
        np.testing.assert_array_less(np.abs(got - want), 1e-5 + 2 * lr * n,
                                     err_msg=name)
        jarr = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate)]
        tarr = _arrays(tt.opt_state[name])
        assert len(jarr) == len(tarr), name
        for a, b in zip(jarr, tarr):
            a = a.T if tr and a.ndim == 2 else a
            np.testing.assert_allclose(b.reshape(a.shape), a, rtol=0,
                                       atol=1e-5, err_msg=f"state {name}")
    if optimizer == "adam":
        assert tt.opt_state["embedding.memory"].step == steps
