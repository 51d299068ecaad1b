"""The exchange demotion ladder, the chunk-fault wrapper and the
ExchangeGuard of the port against the reference's
(``repro.dist.exchange``, ``repro.resilience.faults``,
``repro.resilience.exchange_guard``).

- ``FALLBACK``, ``demote``, ``effective`` and the resolvers under every set
  of demotions (and every forced strategy) equal to the reference's.
- The guard's unit cases of ``tests/test_resilience.py``: a failure retried
  once then demoted, a transient failure that recovers, the finiteness
  check without an oracle, every chunked strategy failing.
- ``FaultyExchange`` mangles the first batch chunk (zeros or NaN) and keeps
  the strategy's name; ``wrap_exchange`` wraps only when a chunk fault is
  armed, and never psum.
- On 4 gloo ranks ((1, 4), CPU), an injected ``drop_chunk`` and a
  ``corrupt_chunk``: the guard demotes all_to_all, then ring, and lands on
  psum, with the reference's guard reaching the same verdict, demotions and
  counters on the same probe outputs; the psum probe is bit-identical to
  the reference's single-device lookup and the mangled chunk is exactly the
  first n / 4 rows; afterwards the cost model's training is bit-equal to a
  psum-pinned run.
- The launcher's ``--exchange`` pins ``FORCED`` ('auto' clears it).
"""
from __future__ import annotations

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dist_ranks as dr  # noqa: E402
from repro.dist import exchange as jexl  # noqa: E402
from repro.embed import EmbeddingTable as JTable  # noqa: E402
from repro.embed import get_scheme as jscheme  # noqa: E402
from repro.resilience import faults as jflt  # noqa: E402
from repro.resilience.exchange_guard import ExchangeGuard as JGuard  # noqa: E402
from repro.resilience.health import Health as JHealth  # noqa: E402
from repro_torch.dist import exchange as exl  # noqa: E402
from repro_torch.dist.collectives import run_ranks  # noqa: E402
from repro_torch.resilience import faults as flt  # noqa: E402
from repro_torch.resilience.exchange_guard import ExchangeGuard  # noqa: E402
from repro_torch.resilience.health import Health  # noqa: E402
from test_torch_dist_cost import _mesh  # noqa: E402

SPECS = ("drop_chunk@0", "corrupt_chunk@0")
CHUNKED = ("all_to_all", "ring")


@pytest.fixture(autouse=True)
def _clean():
    yield
    for m in (exl, jexl):
        m.reset_demotions()
        m.FORCED = None
    flt.install(None)
    jflt.install(None)


def _demote_both(names):
    for m in (exl, jexl):
        m.reset_demotions()
        for n in names:
            m.demote(n, "test")


def test_ladder_equals_reference():
    assert exl.FALLBACK == jexl.FALLBACK
    for order in itertools.permutations(CHUNKED):
        exl.reset_demotions(), jexl.reset_demotions()
        for n in order:
            assert exl.demote(n) == jexl.demote(n)
            for name in ("psum",) + CHUNKED:
                assert exl.effective(name) == jexl.effective(name)
        assert exl.DEMOTED == jexl.DEMOTED
    for m in (exl, jexl):
        with pytest.raises(ValueError):
            m.demote("psum")
        with pytest.raises(KeyError):
            m.demote("bogus")


@pytest.mark.parametrize("P", (2, 4, 8))
def test_resolvers_map_through_demotions(P):
    for r in range(len(CHUNKED) + 1):
        for names in itertools.combinations(CHUNKED, r):
            _demote_both(names)
            for forced in (None, "psum", "ring", "all_to_all"):
                exl.FORCED = jexl.FORCED = forced
                for n, d, a in itertools.product(
                        (4096, 1_703_936), (16, 64),
                        (None, 0.0, 8 * 64 + 8 * 32)):
                    got = exl.resolve_exchange(_mesh(P), n, d, None, None,
                                               a, False, False)
                    want = jexl.resolve_exchange(_mesh(P), n, d, None, None,
                                                 a, False, False)
                    assert got.name == want.name, (names, forced, n, d, a)
                assert exl.resolve_update_exchange(_mesh(P)).name == \
                    jexl.resolve_update_exchange(_mesh(P)).name


def test_guard_demotes_after_retry():
    oracle = np.arange(12, dtype=np.float32).reshape(4, 3)
    calls = []

    def probe(name):
        calls.append(name)
        return np.zeros_like(oracle) if name == "all_to_all" else oracle

    h = Health()
    assert ExchangeGuard(probe, health=h, log=lambda *_: None).validate() \
        == "ring"
    assert "all_to_all" in exl.DEMOTED and "ring" not in exl.DEMOTED
    assert h.exchange_demotions == 1 and h.retries == 1
    assert calls.count("all_to_all") == 2


def test_guard_transient_failure_recovers():
    oracle = torch.ones(4)
    state = {"n": 0}

    def probe(name):
        if name == "all_to_all":
            state["n"] += 1
            if state["n"] == 1:
                return torch.zeros(4)
        return oracle

    h = Health()
    assert ExchangeGuard(probe, health=h, log=lambda *_: None).validate() \
        == "all_to_all"
    assert not exl.DEMOTED and h.exchange_demotions == 0 and h.retries == 1


def test_guard_finite_check_without_oracle():
    def probe(name):
        if name == "all_to_all":
            return torch.tensor([1.0, float("nan")])
        return torch.tensor([1.0, 2.0])

    g = ExchangeGuard(probe, log=lambda *_: None, use_oracle=False)
    assert g.validate() == "ring"
    assert exl.DEMOTED["all_to_all"].startswith("non-finite")


def test_guard_all_chunked_fail_and_a_raising_probe():
    def probe(name):
        if name == "ring":
            raise RuntimeError("link down")
        return torch.ones(4) if name == "psum" else torch.zeros(4)

    h = Health()
    assert ExchangeGuard(probe, health=h, log=lambda *_: None).validate() \
        == "psum"
    assert set(exl.DEMOTED) == set(CHUNKED)
    assert exl.DEMOTED["ring"].startswith("probe raised RuntimeError")
    assert h.exchange_demotions == 2 and h.retries == 2


def test_faulty_exchange_and_wrap_equal_reference():
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    for spec in SPECS:
        wrapped = flt.FaultyExchange(exl.ALL_TO_ALL, flt.FaultInjector(spec))
        jwrapped = jflt.FaultyExchange(jexl.ALL_TO_ALL,
                                       jflt.FaultInjector(spec))
        assert wrapped.name == "all_to_all"
        got = wrapped._mangle(torch.from_numpy(x), 4).numpy()
        want = np.asarray(jwrapped._mangle(jnp.asarray(x), 4))
        np.testing.assert_array_equal(got, want)
        ints = torch.arange(8, dtype=torch.int32)
        np.testing.assert_array_equal(
            wrapped._mangle(ints, 4).numpy(),
            np.asarray(jwrapped._mangle(jnp.arange(8, dtype=jnp.int32), 4)))
    assert flt.wrap_exchange(exl.RING) is exl.RING        # no injector
    flt.install(flt.FaultInjector("drop_chunk@0"))
    assert isinstance(flt.wrap_exchange(exl.RING), flt.FaultyExchange)
    assert flt.wrap_exchange(exl.PSUM) is exl.PSUM        # the oracle
    flt.install(flt.FaultInjector("drop_chunk@3"))        # not armed yet
    assert flt.wrap_exchange(exl.RING) is exl.RING
    flt.install(flt.FaultInjector("nan_grad@0"))
    assert flt.wrap_exchange(exl.RING) is exl.RING


@pytest.fixture(scope="module")
def guarded():
    c = dr.case("hashed_elem", seed=51)
    return c, run_ranks(dr.guard_all, 4, list(SPECS), c, device="cpu")


@pytest.mark.parametrize("spec", SPECS)
def test_chunk_fault_demotes_to_psum_as_the_reference(guarded, spec):
    c, ranks = guarded
    kind, kw = dr.KINDS["hashed_elem"]
    jt = JTable(jscheme(kind).build_config(dr.VOCABS, dr.DIM, dr.BUDGET,
                                           **kw))
    oracle = np.asarray(jt.embed_fields(
        {"memory": jnp.asarray(c["memory"])}, {}, jnp.asarray(c["ids"])))
    n_chunk = c["ids"].size // 4
    for r in ranks:
        res = r[spec]
        assert res["final"] == "psum"
        assert set(res["demoted"]) == set(CHUNKED)
        assert res["health"]["exchange_demotions"] == 2
        assert res["health"]["retries"] == 2
        assert res["after"] == ("psum", "psum")
        np.testing.assert_array_equal(res["probes"]["psum"], oracle)
        for name in CHUNKED:
            got = res["probes"][name].reshape(-1, dr.DIM)
            want = oracle.reshape(-1, dr.DIM)
            np.testing.assert_array_equal(got[n_chunk:], want[n_chunk:])
            if spec.startswith("drop"):
                assert (got[:n_chunk] == 0).all()
            else:
                assert np.isnan(got[:n_chunk]).all()
    # the reference's guard on the same probe outputs
    probes = ranks[0][spec]["probes"]
    h = JHealth()
    final = JGuard(lambda name: probes[name], health=h,
                   log=lambda *_: None).validate()
    assert final == ranks[0][spec]["final"]
    assert set(jexl.DEMOTED) == set(ranks[0][spec]["demoted"])
    for name, reason in jexl.DEMOTED.items():
        assert reason.startswith(ranks[0][spec]["demoted"][name])
    assert h.exchange_demotions == ranks[0][spec]["health"][
        "exchange_demotions"]
    assert h.retries == ranks[0][spec]["health"]["retries"]


@pytest.mark.parametrize("spec", SPECS)
def test_training_after_demotion_bit_equal_to_psum(guarded, spec):
    _, ranks = guarded
    for r in ranks:
        auto, pinned = r[spec]["auto"], r[spec]["pinned"]
        np.testing.assert_array_equal(auto[0], pinned[0])
        np.testing.assert_array_equal(auto[1], pinned[1])
    one = dr.step_train(None, "hashed_elem", "adagrad", None)
    np.testing.assert_array_equal(
        np.concatenate([r[spec]["auto"][1] for r in ranks]), one[1])


def test_launcher_exchange_flag_pins_the_strategy():
    """``--exchange`` sets ``FORCED`` as the reference's launcher does
    ('auto' clears it); the Trainer reports it."""
    from repro_torch.launch import train as tlaunch
    base = ["--device", "cpu", "--smoke", "--embedding-kind", "hashed_elem",
            "--steps", "2", "--batch", "32", "--eval-batches", "1"]
    out = tlaunch.main(base + ["--exchange", "ring"])
    assert exl.FORCED == "ring" and out["train"]["exchange"] == "ring"
    out = tlaunch.main(base + ["--exchange", "auto"])
    assert exl.FORCED is None and out["train"]["exchange"] == "auto"
