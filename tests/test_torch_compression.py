"""The port's schedules and gradient compression (``repro_torch.optim``)
against the JAX reference (``repro.optim``) on the CPU:

- ``warmup_cosine`` and ``constant`` over steps 0 .. total + 5 for four
  settings (warmup 0 included): every operation but the cosine bit-equal
  (with the reference's cosine values put in for PyTorch's), the cosine
  within one float32 ulp of XLA's, and so the schedule within what that
  ulp moves it (half the decay's span times that ulp and one of 1 + cos,
  plus two ulps of the value); the same through ``scale_by_schedule``;
- ``topk_compress``: kept and error bit-equal to the reference on seeded
  gradients, two steps (the second from the first's error);
- ``int8_compress``: the scale bit-equal; each q the floor or the ceiling
  of corrected / scale; the error exactly ``corrected - q * scale`` in
  float32, so ``q * scale + error == corrected`` exactly wherever that
  difference is a float32 (Sterbenz: q = 0, or q * scale within a factor
  of two of corrected) and within half an ulp of the error elsewhere (a
  few elements in a thousand, in the reference as in the port: a small
  corrected value dithered to q = +-1); ``int8_decompress`` bit-equal to
  the reference's on the same (q, scale); the error feedback over 30 steps
  as ``tests/test_optim.py`` holds the reference's.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.optim import compression as jc  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.optim import compression as tc  # noqa: E402

SCHEDULES = [(1e-3, 10, 100, 0.0), (4e-4, 0, 50, 0.0), (3e-4, 7, 33, 1e-5),
             (0.7, 2000, 10_000, 0.05)]


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _grads(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"a.weight": rng.normal(0, 2.0, (64, 32)).astype(np.float32),
            "b.bias": rng.normal(0, 1.0, (1000,)).astype(np.float32),
            "c": rng.standard_t(3, (7, 9, 5)).astype(np.float32)}


def _t(tree: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _j(tree: dict) -> dict:
    return {k: jnp.asarray(np.asarray(v)) for k, v in tree.items()}


class _XlaCos:
    """Within: ``torch.cos`` returns XLA's float32 cosine of its argument,
    so the rest of a schedule's arithmetic can be held bit for bit."""

    def __enter__(self):
        self.saved = torch.cos
        torch.cos = lambda x: torch.from_numpy(np.asarray(jnp.cos(
            jnp.asarray(x.numpy()))))

    def __exit__(self, *exc):
        torch.cos = self.saved


@pytest.mark.parametrize("setting", SCHEDULES, ids=lambda s: f"w{s[1]}")
def test_warmup_cosine_against_reference(setting):
    peak, warmup, total, floor = setting
    steps = np.arange(total + 6, dtype=np.int32)
    want = np.asarray(jopt.warmup_cosine(peak, warmup, total, floor)(
        jnp.asarray(steps)))
    sched = topt.warmup_cosine(peak, warmup, total, floor)
    got = sched(torch.from_numpy(steps)).numpy()
    assert got.dtype == want.dtype == np.float32
    with _XlaCos():
        np.testing.assert_array_equal(
            _bits(sched(torch.from_numpy(steps))), _bits(want))
    prog = np.clip((steps.astype(np.float32) - warmup)
                   / np.float32(max(total - warmup, 1)), 0, 1)
    arg = np.float32(np.pi) * prog
    cos_t = torch.cos(torch.from_numpy(arg)).numpy()
    cos_j = np.asarray(jnp.cos(jnp.asarray(arg)))
    np.testing.assert_array_max_ulp(cos_t, cos_j, maxulp=1)
    # one ulp of the cosine, carried through 1 + cos (which may round to a
    # neighbour of its own) and the float32 multiply and add
    ulp_cos = np.maximum(np.spacing(np.abs(cos_j)), np.spacing(np.abs(cos_t)))
    moved = (peak - floor) * 0.5 * (ulp_cos + np.spacing(1 + cos_j)) \
        + 2 * np.spacing(np.abs(want))
    assert (np.abs(got.astype(np.float64) - want) <= moved).all()
    # the Python int that scale_by_schedule passes gives the same values
    for s in (0, warmup, warmup + 1, total - 1, total, total + 5):
        assert _bits(sched(int(s))) == _bits(got[s])


def test_constant_and_scale_by_schedule():
    steps = np.arange(40, dtype=np.int32)
    np.testing.assert_array_equal(
        _bits(topt.constant(3e-4)(torch.from_numpy(steps))),
        _bits(jopt.constant(3e-4)(jnp.asarray(steps))))
    assert topt.constant(0.1)(7).dtype == torch.float32
    g = np.random.default_rng(0).normal(size=(5, 3)).astype(np.float32)
    jo = jopt.scale_by_schedule(jopt.warmup_cosine(1e-2, 3, 12))
    to = topt.scale_by_schedule(topt.warmup_cosine(1e-2, 3, 12))
    js, ts = jo.init({"w": jnp.asarray(g)}), to.init({"w": torch.zeros(1)})
    for _ in range(15):
        ju, js = jo.update({"w": jnp.asarray(g)}, js)
        with _XlaCos():
            tu, ts = to.update({"w": torch.from_numpy(g)}, ts)
        np.testing.assert_array_equal(_bits(tu["w"]), _bits(ju["w"]))
    assert ts == int(js) == 15


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_bit_equal_to_reference(frac):
    g0, g1 = _grads(1), _grads(2)
    jk, jef = jc.topk_compress(_j(g0), jc.ef_init(_j(g0)), frac=frac)
    tk, tef = tc.topk_compress(_t(g0), tc.ef_init(_t(g0)), frac=frac)
    jk, jef = jc.topk_compress(_j(g1), jef, frac=frac)
    tk, tef = tc.topk_compress(_t(g1), tef, frac=frac)
    for k in g0:
        np.testing.assert_array_equal(_bits(tk[k]), _bits(jk[k]))
        np.testing.assert_array_equal(_bits(tef.error[k]),
                                      _bits(jef.error[k]))
        n = g0[k].size
        assert (tk[k] != 0).sum() >= max(1, int(n * frac))


def test_ef_init():
    params = {"w": torch.zeros(3, 4, dtype=torch.bfloat16), "b": torch.ones(2)}
    ef = topt.ef_init(params)
    assert isinstance(ef, topt.EFState)
    for k, p in params.items():
        assert ef.error[k].dtype == torch.float32
        assert ef.error[k].shape == p.shape and not ef.error[k].any()
    one = tc.ef_init(torch.ones(5))
    assert one.error.shape == (5,) and one.error.dtype == torch.float32


def test_int8_against_reference():
    g = _grads(3)
    err0 = {k: v * np.float32(0.01) for k, v in _grads(4).items()}
    jq, _ = jc.int8_compress(_j(g), jc.EFState(_j(err0)), jax.random.key(0))
    gen = torch.Generator().manual_seed(0)
    tq, tef = tc.int8_compress(_t(g), tc.EFState(_t(err0)), gen)
    again, _ = tc.int8_compress(_t(g), tc.EFState(_t(err0)),
                                torch.Generator().manual_seed(0))
    jd = jc.int8_decompress({k: (jnp.asarray(q.numpy()), jnp.asarray(
        s.numpy())) for k, (q, s) in tq.items()})
    td = tc.int8_decompress(tq)
    sterbenz_misses = 0
    for k in g:
        q, s = tq[k]
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert _bits(s) == _bits(jq[k][1])              # the scale
        assert torch.equal(q, again[k][0])               # the generator's
        corrected = torch.from_numpy(g[k]) + torch.from_numpy(err0[k])
        r = corrected / s
        qf = q.to(torch.float32)
        assert bool(((qf == torch.floor(r)) | (qf == torch.ceil(r))).all())
        deq = qf * s
        err = tef.error[k]
        np.testing.assert_array_equal(_bits(err), _bits(corrected - deq))
        np.testing.assert_array_equal(_bits(td[k]), _bits(jd[k]))
        np.testing.assert_array_equal(_bits(td[k]), _bits(deq))
        back = deq.double() + err.double()
        exact = (q == 0) | ((deq.abs() <= 2 * corrected.abs())
                            & (corrected.abs() <= 2 * deq.abs()))
        assert torch.equal(back[exact], corrected.double()[exact])
        ulp = torch.nextafter(err.abs(), torch.tensor(np.inf)) - err.abs()
        assert bool(((back - corrected.double()).abs()
                     <= 0.5 * ulp.double()).all())
        sterbenz_misses += int((back != corrected.double()).sum())
    assert sterbenz_misses < 0.01 * sum(v.size for v in g.values())


def test_int8_error_feedback_sums():
    """kept_t + err_t == grad_t + err_{t-1}: over 30 steps the sent total
    trails the gradients' total by the last error alone."""
    rng = np.random.default_rng(1)
    g = {"w": torch.from_numpy(rng.normal(size=(32,)).astype(np.float32))}
    ef = tc.ef_init(g)
    gen = torch.Generator().manual_seed(7)
    sent, total = np.zeros(32), np.zeros(32)
    for _ in range(30):
        gt = {"w": torch.from_numpy(rng.normal(size=(32,))
                                    .astype(np.float32))}
        q, ef = tc.int8_compress(gt, ef, gen)
        sent += tc.int8_decompress(q)["w"].double().numpy()
        total += gt["w"].double().numpy()
    residual = np.abs(total - sent)
    assert residual.max() < 0.2, residual.max()
    np.testing.assert_allclose(residual, np.abs(ef.error["w"].numpy()),
                               atol=1e-5)
    # the round-trip error of one step: at most 1.5 quanta of dither
    x = {"w": torch.from_numpy(rng.normal(0, 2.0, (64, 32))
                               .astype(np.float32))}
    q, _ = tc.int8_compress(x, tc.ef_init(x), gen)
    scale = float(x["w"].abs().max()) / 127.0
    assert float((tc.int8_decompress(q)["w"] - x["w"]).abs().max()) \
        <= scale * 1.51 + 1e-7


def test_topk_error_feedback():
    rng = np.random.default_rng(2)
    g = {"w": torch.from_numpy(rng.normal(size=(1000,)).astype(np.float32))}
    kept, ef = tc.topk_compress(g, tc.ef_init(g), frac=0.01)
    k = kept["w"].numpy()
    assert (k != 0).sum() <= 1000 * 0.011 + 1
    thresh = np.sort(np.abs(g["w"].numpy()))[-10]
    assert np.abs(k[k != 0]).min() >= thresh
    np.testing.assert_array_equal(k + ef.error["w"].numpy(), g["w"].numpy())
    const = {"w": torch.from_numpy(np.concatenate(
        [np.full(10, 1.0), np.full(990, 0.01)]).astype(np.float32))}
    ef, sent = tc.ef_init(const), np.zeros(1000)
    for _ in range(120):
        kept, ef = tc.topk_compress(const, ef, frac=0.01)
        sent += kept["w"].double().numpy()
    assert sent[999] > 0.0
