"""Pool integrity, fault injection, health and the chaos schedule against
the JAX reference (``repro.resilience``), bit for bit.

- chunk checksums on a tensor equal the reference's device and numpy
  checksums, for float32 and int32 leaves, pool sizes a multiple of
  ``CHUNK`` or not, keys with the top bit set;
- the scan flags and quarantines exactly the reference's chunks (NaN, inf,
  overflow-scale), in place, and is a bitwise no-op on a clean leaf;
- ``parse_faults``, ``rot_memory``'s flipped bits, ``torn_ckpt`` fractions,
  the consumed-once hooks and ``make_schedule``'s strings equal the
  reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.resilience import chaos as jchaos  # noqa: E402
from repro.resilience import faults as jflt  # noqa: E402
from repro.resilience import health as jhealth  # noqa: E402
from repro.resilience import integrity as jint  # noqa: E402
from repro_torch.resilience import chaos as tchaos  # noqa: E402
from repro_torch.resilience import faults as tflt  # noqa: E402
from repro_torch.resilience import health as thealth  # noqa: E402
from repro_torch.resilience import integrity as tint  # noqa: E402

C = tint.CHUNK
SIZES = [3 * C, 2 * C + 17, 5, C]


@pytest.fixture(autouse=True)
def _uninstall():
    yield
    tflt.install(None)
    jflt.install(None)


def _pool(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        return rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    return rng.normal(size=n).astype(np.float32)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_chunk_checksums_bit_identical(n, dtype):
    a = _pool(n, 1, dtype)
    want = np.asarray(jint.chunk_checksums(jnp.asarray(a)))
    np.testing.assert_array_equal(jint.np_chunk_checksums(a), want)
    np.testing.assert_array_equal(tint.np_chunk_checksums(a), want)
    got = tint.chunk_checksums(torch.from_numpy(a))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


@pytest.mark.parametrize("n", SIZES)
def test_scan_and_quarantine_bit_identical(n):
    a = _pool(n, 2)
    a[min(3, n - 1)] = np.inf
    if n > C + 5:
        a[C + 5] = np.nan
    a[n - 1] = 3e38                      # overflow-scale, finite
    want_bad = np.asarray(jint.bad_value_chunks(jnp.asarray(a)))
    want, want_n = jint.sanitize(jnp.asarray(a))
    t = torch.from_numpy(a.copy())
    np.testing.assert_array_equal(tint.bad_value_chunks(t).numpy(), want_bad)
    np.testing.assert_array_equal(tint.np_bad_value_chunks(a), want_bad)
    ptr = t.data_ptr()
    out, n_bad = tint.sanitize(t)
    assert out.data_ptr() == ptr and n_bad == int(want_n)   # in place
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))
    host, host_n = tint.np_sanitize(a)
    assert host_n == int(want_n)
    np.testing.assert_array_equal(host, np.asarray(want))


def test_scan_of_a_clean_leaf_is_a_bitwise_noop():
    a = _pool(2 * C + 17, 3)
    a[5] = -0.0
    t = torch.from_numpy(a.copy())
    _, n_bad = tint.sanitize(t)
    assert n_bad == 0
    assert t.numpy().tobytes() == a.tobytes()
    assert int(tint.bad_value_chunks(torch.arange(40, dtype=torch.int32)
                                     ).sum()) == 0


def test_sanitize_tree_reaches_memory_leaves_only():
    bad = _pool(2 * C, 4)
    bad[C + 1] = np.nan
    tree = {"embedding.memory": torch.from_numpy(bad.copy()),
            "w": torch.from_numpy(bad.copy()),
            "opt": (torch.tensor(3), {"linear.memory": torch.from_numpy(
                bad.copy())})}
    _, n = tint.sanitize_tree(tree)
    assert n == 2
    assert torch.isnan(tree["w"]).any()
    assert not torch.isnan(tree["embedding.memory"]).any()
    assert not torch.isnan(tree["opt"][1]["linear.memory"]).any()


SPECS = ["nan_grad@17, rot_row@40:8 ,slow_rank@55:0.5",
         "torn_ckpt@3:0.5,stage_fail@2,read_fail@0,preempt@9",
         "drop_chunk@4,corrupt_chunk@1,huge_grad@2:7.5,inf_grad@3", ""]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_faults_matches_reference(spec):
    want = [dataclasses.astuple(f) for f in jflt.parse_faults(spec)]
    assert [dataclasses.astuple(f) for f in tflt.parse_faults(spec)] == want


@pytest.mark.parametrize("bad", ["bad_kind@3", "nan_grad", "nan_grad@x",
                                 "rot_row@3:y"])
def test_parse_faults_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError) as want:
        jflt.parse_faults(bad)
    with pytest.raises(ValueError) as got:
        tflt.parse_faults(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed,step,n", [(0, 40, 8), (3, 7, 4),
                                         (2**31 + 1, 0, 8), (1, 5, 10**6)])
@pytest.mark.parametrize("size", [C + 3, 64])
def test_rot_memory_flips_the_reference_bits(seed, step, n, size):
    a = _pool(size, 5)
    params = {"embedding": {"memory": jnp.asarray(a)},
              "w": jnp.asarray(a[:4])}
    want = jflt.FaultInjector("", seed).rot_memory(params, step, n)
    mine = {"embedding.memory": torch.from_numpy(a.copy()),
            "w": torch.from_numpy(a[:4].copy())}
    tflt.FaultInjector("", seed).rot_memory(mine, step, n)
    np.testing.assert_array_equal(
        mine["embedding.memory"].numpy().view(np.uint32),
        np.asarray(want["embedding"]["memory"]).view(np.uint32))
    np.testing.assert_array_equal(mine["w"].numpy(), a[:4])


@pytest.mark.parametrize("spec,seed", [("torn_ckpt@3", 1),
                                       ("torn_ckpt@7", 2**31 + 4),
                                       ("torn_ckpt@3:0.5", 0),
                                       ("torn_ckpt@3:1.7", 0)])
def test_torn_fraction_matches_reference(spec, seed):
    j, t = jflt.FaultInjector(spec, seed), tflt.FaultInjector(spec, seed)
    j.now = t.now = 10
    assert t.torn_ckpt_fault() == j.torn_ckpt_fault()
    assert t.torn_ckpt_fault() is None and j.torn_ckpt_fault() is None


def test_hooks_fire_once_and_from_env(monkeypatch):
    inj = tflt.FaultInjector("inf_grad@2,slow_rank@3,read_fail@4,"
                             "stage_fail@1")
    assert inj.grad_fault(1) == 1.0
    assert inj.grad_fault(2) == float("inf") and inj.grad_fault(2) == 1.0
    assert inj.step_delay(3) == 0.25 and inj.step_delay(3) == 0.0
    assert not inj.io_fault()                 # now = 3 < 4
    inj.now = 4
    tflt.install(inj)
    assert tflt.io_fault() and not tflt.io_fault()
    assert tflt.stage_fail() and not tflt.stage_fail()
    inj.reset()
    assert inj.grad_fault(2) == float("inf")
    monkeypatch.setenv("REPRO_FAULTS", "nan_grad@5")
    monkeypatch.setenv("REPRO_FAULTS_SEED", "7")
    env = tflt.from_env()
    assert env.seed == 7 and tflt.active_injector() is env
    monkeypatch.setenv("REPRO_FAULTS", "")
    assert tflt.from_env() is None


@pytest.mark.parametrize("total,seed,kinds,min_step", [
    (200, 8, ("preempt", "torn_ckpt", "rot_row", "nan_grad"), 21),
    (200, 16, None, 21), (48, 3, None, 5), (24, 11, None, 1)])
def test_make_schedule_strings_match_reference(total, seed, kinds, min_step):
    kw = {} if kinds is None else {"kinds": kinds}
    assert tchaos.make_schedule(total, seed=seed, min_step=min_step, **kw) \
        == jchaos.make_schedule(total, seed=seed, min_step=min_step, **kw)
    assert tchaos.SOAK_KINDS == jchaos.SOAK_KINDS


def test_health_record_matches_reference():
    t, j = thealth.Health(), jhealth.Health()
    assert t.as_dict() == j.as_dict()
    for h in (t, j):
        h.skipped_steps, h.last_durable_step = 2, 40
    assert t.summary() == j.summary() == "skipped_steps=2"
    assert t.any_faults() and j.any_faults()
