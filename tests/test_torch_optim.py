"""The port's optimizers against the JAX reference (``repro.optim``) on the
CPU, run op by op on both sides, from the same parameters and gradients
(numpy, from a seed):

- 10 steps of dense ``sgd`` (momentum), ``adam``, ``adamw``, ``scale``,
  ``scale_by_schedule`` and ``chain(clip_by_global_norm, adam)``, and of
  ``sparse_sgd`` and ``sparse_rowwise_adam`` on SparseGrad leaves (flat
  deduped, bucketed, and row mode), bit-equal: updates, parameters and
  moments.  The one exception is ``clip_by_global_norm`` while it clips:
  the norm is a float32 sum whose order XLA picks, so the clipped steps are
  held to 1e-6 of each array's largest magnitude (bit-equal while it does
  not clip).
- The bias corrections ``1 - b ** step`` equal XLA's at every step.
- Lazy semantics: untouched slots keep their moments and parameters bit
  for bit; momentum on a touched slot carries over.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import optimizers as jopt  # noqa: E402
from repro.optim import sparse as jsp  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim import sparse as tsp  # noqa: E402

M, D = 512, 8


def _params(seed=0):
    rng = np.random.default_rng(seed)
    return {"a.w": rng.normal(size=(6, 5)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32),
            "memory": rng.normal(size=(M,)).astype(np.float32)}


def _grads(rng, params):
    return {k: rng.normal(size=v.shape).astype(np.float32)
            for k, v in params.items()}


def _leaves(tree):
    """Every array of a state, in a fixed order (JAX and port alike)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [np.asarray(tree)]


def _dense_run(jmake, tmake, steps=10, exact=True):
    """``steps`` updates from the same params and gradients on both sides,
    each step's updates, params and states compared."""
    p0 = _params()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jo, to = jmake(), tmake()
    js, ts = jo.init(jp), to.init(tp)
    rng = np.random.default_rng(1)
    for step in range(steps):
        g = _grads(rng, p0)
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = to.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
        jp = jopt.apply_updates(jp, ju)
        topt.apply_updates(tp, tu)
        for k in p0:
            if exact:
                assert np.array_equal(np.asarray(ju[k]), tu[k].numpy()), \
                    (step, k)
                assert np.array_equal(np.asarray(jp[k]), tp[k].numpy())
            else:
                _close(tp[k].numpy(), np.asarray(jp[k]))
        for a, b in zip(_leaves(js), _leaves(_torch_state(ts))):
            if exact:
                assert np.array_equal(a, b), step
            else:
                _close(b, a)


def _close(got, want):
    """1e-6 of the array's largest magnitude: a momentum or parameter sums
    clipped gradients of both signs, each off by the clip factor's rounding
    (1e-6 relative at most), so its error scales with the terms it sums,
    not with itself."""
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


def _torch_state(s):
    if isinstance(s, torch.Tensor):
        return s.numpy()
    if isinstance(s, dict):
        return {k: _torch_state(v) for k, v in s.items()}
    if isinstance(s, tuple):                     # NamedTuple states too
        return tuple(_torch_state(v) for v in s)
    return s


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "scale",
                                  "schedule", "chain_clip_off"])
def test_dense_optimizers_bitwise(name):
    make = {
        "sgd": lambda o: o.sgd(0.05, momentum=0.9),
        "adam": lambda o: o.adam(1e-2),
        "adamw": lambda o: o.adamw(1e-2, weight_decay=0.05),
        "scale": lambda o: o.scale(-0.25),
        "schedule": lambda o: o.scale_by_schedule(lambda s: 0.5 ** s),
        "chain_clip_off": lambda o: o.chain(o.clip_by_global_norm(1e6),
                                            o.adam(1e-2)),
    }[name]
    _dense_run(lambda: make(jopt), lambda: make(topt))


def test_chain_clip_by_global_norm_active():
    """The norm (about 23) is clipped to 1 at every step: the norm is a
    float32 sum in XLA's order, so the tolerance of ``_close``."""
    def make(o):
        return o.chain(o.clip_by_global_norm(1.0), o.sgd(0.1, momentum=0.9))
    _dense_run(lambda: make(jopt), lambda: make(topt), exact=False)


def test_bias_corrections_match_xla():
    steps = jnp.arange(1, 2001, dtype=jnp.int32)
    for b in (0.9, 0.999, 0.99):
        want = np.asarray(jax.jit(lambda s: 1 - b ** s.astype(jnp.float32))(
            steps))
        got = np.asarray([topt.bias_correction(b, int(s)) for s in steps],
                         np.float32)
        assert np.array_equal(want, got), b


def _sparse_grad(rng, layout):
    """-> (the reference's SparseGrad, the port's), built by each package's
    own builder from the same locations and values."""
    if layout == "flat":
        loc = rng.integers(0, M // 2, 300).astype(np.int32)
        vals = rng.normal(size=300).astype(np.float32)
        shape = (M,)
        return (jsp.from_locations(jnp.asarray(loc), jnp.asarray(vals), shape),
                tsp.from_locations(torch.from_numpy(loc),
                                   torch.from_numpy(vals), shape))
    if layout == "bucketed":
        stripe = M // D
        loc = (np.arange(D)[None, :] * stripe
               + rng.integers(0, stripe // 4, (40, D))).astype(np.int32)
        vals = rng.normal(size=(40, D)).astype(np.float32)
        return (jsp.from_bucketed_locations(jnp.asarray(loc),
                                            jnp.asarray(vals), (M,)),
                tsp.from_bucketed_locations(torch.from_numpy(loc),
                                            torch.from_numpy(vals), (M,)))
    rows = rng.integers(0, M // D // 2, 50).astype(np.int32)
    vals = rng.normal(size=(50, D)).astype(np.float32)
    shape = (M // D, D)
    return (jsp.from_locations(jnp.asarray(rows), jnp.asarray(vals), shape),
            tsp.from_locations(torch.from_numpy(rows), torch.from_numpy(vals),
                               shape))


@pytest.mark.parametrize("layout", ["flat", "bucketed", "rows"])
@pytest.mark.parametrize("name", ["sparse_sgd", "sparse_rowwise_adam",
                                  "sgd", "adamw"])
def test_sparse_leaf_optimizers_bitwise(name, layout):
    """10 steps of a SparseGrad pool leaf (a flat [m] parameter, its states
    viewed in the SparseGrad's layout) through each optimizer: updates,
    pool and moments bit-equal to the reference; the slots no step touched
    keep their parameter and moment bits."""
    make = {"sparse_sgd": lambda o, s: s.sparse_sgd(0.05, momentum=0.9),
            "sparse_rowwise_adam": lambda o, s: s.sparse_rowwise_adam(1e-2),
            "sgd": lambda o, s: o.sgd(0.05, momentum=0.9),
            "adamw": lambda o, s: o.adamw(1e-2, weight_decay=0.05)}[name]
    rng = np.random.default_rng(3)
    p0 = rng.normal(size=M).astype(np.float32)
    jp, tp = {"memory": jnp.asarray(p0)}, {"memory": torch.from_numpy(p0.copy())}
    jo, to = make(jopt, jsp), make(topt, tsp)
    js, ts = jo.init(jp), to.init(tp)
    touched = np.zeros(M, bool)
    for step in range(10):
        jg, tg = _sparse_grad(rng, layout)
        idx = tg.indices.numpy()
        idx = idx[idx < tg.sentinel]
        if layout == "rows":
            idx = (idx[:, None] * D + np.arange(D)).reshape(-1)
        touched[idx] = True
        assert np.array_equal(np.asarray(jg.indices), tg.indices.numpy())
        assert np.array_equal(np.asarray(jg.values), tg.values.numpy())
        ju, js = jo.update({"memory": jg}, js, jp)
        tu, ts = to.update({"memory": tg}, ts, tp)
        assert np.array_equal(np.asarray(ju["memory"].values),
                              tu["memory"].values.numpy()), step
        jp = jopt.apply_updates(jp, ju)
        topt.apply_updates(tp, tu)
        assert np.array_equal(np.asarray(jp["memory"]), tp["memory"].numpy())
        for a, b in zip(_leaves(js), _leaves(_torch_state(ts))):
            assert np.array_equal(a, b.reshape(a.shape)), step
    assert (~touched).sum() > M // 4
    assert np.array_equal(tp["memory"].numpy()[~touched].view(np.int32),
                          p0[~touched].view(np.int32))
    for s in _leaves(_torch_state(ts)):
        if s.size == M:
            assert not s.reshape(-1)[~touched].any()     # moments stay 0


def test_untouched_slot_moments_bit_invariant():
    """The reference's test of the same name, for the port's lazy SGD and
    Adam: slots no index touches keep their state bits."""
    rng = np.random.default_rng(0)
    touched = np.asarray([7, 8, 100])
    for opt in (tsp.sparse_sgd(0.1, 0.9), tsp.sparse_rowwise_adam(0.1),
                tsp.sparse_adagrad(0.1)):
        p = {"memory": torch.from_numpy(rng.normal(size=256)
                                        .astype(np.float32))}
        state = opt.init(p)
        for s in _state_tensors(state):
            s.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, 256)
                                     .astype(np.float32)))
        before = [s.clone() for s in _state_tensors(state)]
        sg = tsp.from_locations(torch.from_numpy(touched.astype(np.int32)),
                                torch.tensor([1.0, -2.0, 3.0]), (256,))
        upd, state = opt.update({"memory": sg}, state, p)
        untouched = np.setdiff1d(np.arange(256), touched)
        for s0, s in zip(before, _state_tensors(state)):
            assert torch.equal(s0[untouched].view(torch.int32),
                               s[untouched].view(torch.int32))
            assert not torch.equal(s0[touched], s[touched])
        assert not upd["memory"].densify()[untouched].any()


def _state_tensors(state):
    if isinstance(state, torch.Tensor):
        return [state]
    if isinstance(state, dict):
        return [t for k in sorted(state) for t in _state_tensors(state[k])]
    if isinstance(state, tuple):
        return [t for s in state for t in _state_tensors(s)]
    return []


def test_sgd_momentum_sparse_leaf_lazy():
    """The reference's test of the same name: lazy momentum on slot 2,
    u1 = -1.0, u2 = -(0.5 * 1 + 1) = -1.5, nothing else moves."""
    m = 8
    p = {"w": torch.zeros(m)}
    opt = topt.sgd(1.0, momentum=0.5)
    state = opt.init(p)
    sg = tsp.from_locations(torch.tensor([2], dtype=torch.int32),
                            torch.tensor([1.0]), (m,))
    for _ in range(2):
        upd, state = opt.update({"w": sg}, state, p)
        topt.apply_updates(p, upd)
    assert float(p["w"][2]) == -2.5
    assert float(p["w"].abs().sum()) == 2.5


def test_multi_transform_keeps_one_adam_state_per_leaf():
    """As the reference: each routed leaf has its own AdamState (and step);
    a pool routed to the sparse optimizer, the rest to dense Adam."""
    params = {k: torch.from_numpy(v) for k, v in _params().items()}
    opt = topt.multi_transform([(r"(^|\.)memory$",
                                 tsp.sparse_rowwise_adam(1e-2))],
                               default=topt.adam(1e-2))
    state = opt.init(params)
    assert isinstance(state["memory"], tsp.RowwiseAdamState)
    assert isinstance(state["b"], topt.AdamState)
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    _, state = opt.update(grads, state, params)
    _, state = opt.update({"b": grads["b"]}, state, params)
    assert state["b"].step == 2 and state["memory"].step == 1


@pytest.mark.parametrize("shape", [(37, 5), (4, 3, 6), (301,)])
def test_sliced_adam_update_bit_equal(monkeypatch, shape):
    """A dense leaf past ``ADAM_SLICE`` elements is updated a slice of rows
    at a time: updates and moments bit-equal to the whole leaf's, weight
    decay included, for 3 steps."""
    rng = np.random.default_rng(11)
    p = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    grads = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
             for _ in range(3)]
    out = {}
    for sliced in (False, True):
        monkeypatch.setattr(tsp, "ADAM_SLICE", 7 if sliced else 1 << 26)
        opt = topt.adamw(1e-2, weight_decay=0.1)
        q = {"w": p.clone()}
        state = opt.init(q)
        ups = []
        for g in grads:
            u, state = opt.update({"w": g}, state, q)
            topt.apply_updates(q, u)
            ups.append(u["w"])
        out[sliced] = ups + [q["w"], state.mu["w"], state.nu["w"]]
    for a, b in zip(out[False], out[True]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
