"""The port's CheckpointManager against the reference's
(``repro.checkpoint.manager``): the counterparts of
``tests/test_checkpoint.py`` and of the manager cases of
``tests/test_durability.py``, plus the on-disk format both ways.

Each scenario runs the port's manager; where the reference's restores the
same directory (a copy, so both read the same bytes), the restored arrays
are bit-identical and the restore reports equal.  A directory either
package writes restores in the other, and the same saves write
byte-identical manifests.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.checkpoint import manager as jm  # noqa: E402
from repro.resilience import faults as jflt  # noqa: E402
from repro_torch.checkpoint import manager as tm  # noqa: E402
from repro_torch.resilience import faults as tflt  # noqa: E402

CHUNK = 8192
MGR = {"torch": tm.CheckpointManager, "jax": jm.CheckpointManager}


@pytest.fixture(autouse=True)
def _uninstall():
    yield
    tflt.install(None)
    jflt.install(None)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.normal(0, 1, (4, 3)).astype(np.float32),
                   "b": rng.normal(0, 1, 3).astype(np.float32)},
        "opt": ({"m": np.zeros((4, 3), np.float32)},
                {"v": np.ones((4, 3), np.float32)}),
        "step": np.asarray(7, np.int32),
    }


def _pool_tree(seed=0, m=3 * CHUNK):
    rng = np.random.default_rng(seed)
    return {"params": {"memory": rng.normal(0, 0.1, (m,)).astype(np.float32),
                       "w": rng.normal(0, 1, (4, 3)).astype(np.float32)},
            "step": np.asarray(seed, np.int32)}


def _pool_state(seed=0, m=8 * CHUNK, step=0):
    rng = np.random.default_rng(seed)
    return {"params": {"memory": rng.normal(0, .1, m).astype(np.float32),
                       "w": rng.normal(0, 1, (4, 3)).astype(np.float32)},
            "opt": {"memory": np.zeros(m, np.float32)},
            "step": np.asarray(step, np.int32)}


def _equal(got, want):
    g, w = tm._flatten(got), tm._flatten(want)
    assert set(g) == set(w)
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.tobytes() == b.tobytes(), k


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:010d}", "manifest.json")) as f:
        return json.load(f)


def _truncate(d, step, size):
    npz = os.path.join(d, f"step_{step:010d}", "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(size(os.path.getsize(npz)))


def _both_restore(tmp_path, d, **kw):
    """Restore ``d`` with the port's manager and a copy with the
    reference's: -> (step, tree, report) of the port's, after holding the
    reference's to it."""
    ref = str(tmp_path / "reference-reader")
    shutil.copytree(d, ref)
    tmgr, jmgr = tm.CheckpointManager(d), jm.CheckpointManager(ref)
    step, tree = tmgr.restore(**kw)
    jstep, jtree = jmgr.restore(**kw)
    assert step == jstep
    _equal(tree, jtree)
    assert tmgr.last_restore_report == jmgr.last_restore_report
    return step, tree, tmgr.last_restore_report


# ------------------------------------------------ tests/test_checkpoint.py

@pytest.mark.parametrize("writer", ["torch", "jax"])
@pytest.mark.parametrize("reader", ["torch", "jax"])
def test_roundtrip(tmp_path, writer, reader):
    MGR[writer](str(tmp_path), keep=3).save(10, _tree())
    step, restored = MGR[reader](str(tmp_path), keep=3).restore()
    assert step == 10
    _equal(restored, _tree())


def test_latest_and_retention(tmp_path):
    mgr = tm.CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.latest_step() == 4
    assert len([d for d in os.listdir(tmp_path) if d.startswith("step_")]) \
        == 2
    _equal(mgr.restore()[1], _tree(4))


def test_async_save_snapshots_tensors_before_returning(tmp_path):
    """The port updates tensors in place: an async save must have copied
    them when it returns, so a later update is not what lands."""
    mgr = tm.CheckpointManager(str(tmp_path), keep=3)
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    tree = {"params": {"w": w}, "step": np.asarray(5, np.int32)}
    mgr.save(5, tree, blocking=False)
    w.add_(100.0)
    mgr.wait()
    step, restored = mgr.restore()
    assert step == 5
    np.testing.assert_array_equal(restored["params"]["w"],
                                  np.arange(12, dtype=np.float32
                                            ).reshape(4, 3))


def test_async_write_failure_raises_in_wait(tmp_path):
    mgr = tm.CheckpointManager(str(tmp_path), keep=3)

    def broken(*a):
        raise OSError("disk full")

    mgr._write = broken
    mgr.save(1, _tree(), blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                                   # reported once


def test_checksum_detects_corruption(tmp_path):
    mgr = tm.CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree())
    man_path = os.path.join(tmp_path, "step_0000000001", "manifest.json")
    man = _manifest(tmp_path, 1)
    man["checksum"] = "0" * 64
    with open(man_path, "w") as f:
        json.dump(man, f)
    with pytest.raises(IOError):
        mgr.restore()
    assert mgr.restore(verify=False)[0] == 1


def test_no_tmp_dirs_left_behind(tmp_path):
    tm.CheckpointManager(str(tmp_path), keep=3).save(1, _tree())
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    assert not [f for _, _, fs in os.walk(tmp_path) for f in fs
                if f.endswith(".part")]


def test_latest_marker_fallback(tmp_path):
    mgr = tm.CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))
    shutil.rmtree(os.path.join(tmp_path, "step_0000000002"))
    assert mgr.latest_step() == 1
    assert mgr.restore()[0] == 1


def test_idempotent_save(tmp_path):
    mgr = tm.CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(1))
    mgr.save(1, _tree(99))
    _equal(mgr.restore()[1], _tree(1))


def test_tensor_leaves_restore_as_host_arrays(tmp_path):
    """The port's counterpart of the elastic restore: leaves saved from
    tensors (int32 and float32) come back as numpy arrays of the same
    dtype and bytes, for the caller to copy where they belong."""
    mgr = tm.CheckpointManager(str(tmp_path), keep=3)
    tree = {"a": torch.arange(6, dtype=torch.int32),
            "b": (torch.full((2, 2), -0.0), torch.tensor(3.5))}
    mgr.save(3, tree)
    _, restored = mgr.restore()
    assert isinstance(restored["a"], np.ndarray)
    _equal(restored, {"a": np.arange(6, dtype=np.int32),
                      "b": (np.full((2, 2), -0.0, np.float32),
                            np.asarray(3.5, np.float32))})


_leaf = st.one_of(
    st.integers(-5, 5).map(lambda i: np.asarray(i, np.int32)),
    st.lists(st.floats(-1, 1, width=32), min_size=1, max_size=4)
      .map(lambda l: np.asarray(l, np.float32)))
_trees = st.recursive(
    _leaf, lambda children: st.one_of(
        st.dictionaries(st.sampled_from(list("abcd")), children,
                        min_size=1, max_size=3),
        st.tuples(children, children)), max_leaves=8)


@settings(max_examples=30, deadline=None)
@given(tree=_trees)
def test_property_flatten_unflatten_roundtrip(tree):
    flat = tm._flatten(tree)
    assert flat.keys() == jm._flatten(tree).keys()
    _equal(tm._unflatten(flat), tree)


def test_restore_falls_back_on_truncated_latest(tmp_path):
    mgr = tm.CheckpointManager(str(tmp_path / "a"), keep=3)
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))
    _truncate(tmp_path / "a", 2, lambda n: n // 2)
    step, restored, report = _both_restore(tmp_path, str(tmp_path / "a"))
    assert step == 1 and report["fell_back_from"] == 2
    _equal(restored, _tree(1))
    solo = tm.CheckpointManager(str(tmp_path / "solo"), keep=3)
    solo.save(7, _tree(7))
    _truncate(tmp_path / "solo", 7, lambda n: 10)
    with pytest.raises(IOError, match="no restorable checkpoint"):
        solo.restore()


def test_explicit_step_never_falls_back(tmp_path):
    mgr = tm.CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))
    _truncate(tmp_path, 2, lambda n: 10)
    with pytest.raises(Exception):
        mgr.restore(step=2)
    assert mgr.restore(step=1)[0] == 1


def test_chunk_repair_quarantines_pool_corruption(tmp_path):
    d = str(tmp_path / "a")
    mgr = tm.CheckpointManager(d, keep=3)
    tree = _pool_tree(3)
    mgr.save(3, tree)
    npz = os.path.join(d, "step_0000000003", "arrays.npz")
    with np.load(npz) as z:
        host = {k: z[k].copy() for k in z.files}
    host["params/memory"][CHUNK + 5] += 1.0
    np.savez(npz, **host)
    step, restored, report = _both_restore(tmp_path, d)
    assert step == 3
    mem, want = restored["params"]["memory"], tree["params"]["memory"]
    np.testing.assert_array_equal(mem[:CHUNK], want[:CHUNK])
    assert (mem[CHUNK:2 * CHUNK] == 0).all()
    np.testing.assert_array_equal(mem[2 * CHUNK:], want[2 * CHUNK:])
    assert report == {"quarantined_chunks": 1,
                      "repaired_leaves": ["params/memory"],
                      "fell_back_from": None, "torn_writes": 0,
                      "chain_len": 0}


def test_non_pool_corruption_falls_back(tmp_path):
    d = str(tmp_path / "a")
    mgr = tm.CheckpointManager(d, keep=3)
    mgr.save(1, _pool_tree(1))
    mgr.save(2, _pool_tree(2))
    npz = os.path.join(d, "step_0000000002", "arrays.npz")
    with np.load(npz) as z:
        host = {k: z[k].copy() for k in z.files}
    host["params/w"][0, 0] += 1.0
    np.savez(npz, **host)
    step, _, report = _both_restore(tmp_path, d)
    assert step == 1 and report["fell_back_from"] == 2


def test_save_refuses_nonfinite(tmp_path):
    mgr = tm.CheckpointManager(str(tmp_path), keep=3)
    tree = _tree()
    tree["params"]["w"][0, 0] = np.nan
    with pytest.raises(ValueError, match="refusing to persist non-finite"):
        mgr.save(1, tree)
    tree["params"]["w"] = torch.from_numpy(tree["params"]["w"])
    with pytest.raises(ValueError, match="refusing to persist non-finite"):
        mgr.save(1, tree, blocking=False)        # refused synchronously
    assert mgr.latest_step() is None
    mgr.save(1, tree, check_finite=False)
    assert mgr.latest_step() == 1


def test_injected_read_failure_falls_back(tmp_path):
    mgr = tm.CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, _tree(1))
    mgr.save(2, _tree(2))
    tflt.install(tflt.FaultInjector("read_fail@0"))
    step, _ = mgr.restore()
    assert step == 1 and mgr.last_restore_report["fell_back_from"] == 2


# --------------------------------- the manager cases of test_durability.py

@pytest.mark.parametrize("slots", ["numpy", "tensor"])
def test_delta_roundtrip_and_byte_savings(tmp_path, slots):
    d = str(tmp_path / "a")
    mgr = tm.CheckpointManager(d, keep=3, delta=True)
    state = _pool_state(0)
    mgr.save(0, state)
    base_bytes = mgr.last_save_bytes
    assert _manifest(d, 0)["kind"] == "base"
    state["params"]["memory"][CHUNK + 3: CHUNK + 13] += 1.0
    state["step"] = np.asarray(5, np.int32)
    marked = np.arange(CHUNK + 3, CHUNK + 13)
    mgr.mark_dirty_slots(marked if slots == "numpy"
                         else torch.from_numpy(marked))
    mgr.save(5, state)
    man = _manifest(d, 5)
    assert man["kind"] == "delta" and man["base_step"] == 0
    assert man["delta"]["params/memory"]["chunks"] == [1]
    assert mgr.last_save_bytes < base_bytes / 4
    assert mgr.chain_len == 1
    step, restored, report = _both_restore(tmp_path, d)
    assert step == 5 and report["chain_len"] == 1
    _equal(restored, state)
    state["params"]["memory"][0] += 2.0
    state["step"] = np.asarray(10, np.int32)
    mgr.restore()
    mgr.mark_dirty_slots([0])
    mgr.save(10, state)
    assert _manifest(d, 10)["kind"] == "delta"
    _equal(mgr.restore()[1], state)


def test_delta_catches_unmarked_mutation(tmp_path):
    mgr = tm.CheckpointManager(str(tmp_path), keep=3, delta=True)
    state = _pool_state(1)
    mgr.save(0, state)
    state["opt"]["memory"][5 * CHUNK + 7] = 9.0
    state["step"] = np.asarray(5, np.int32)
    mgr.save(5, state)
    man = _manifest(tmp_path, 5)
    assert man["kind"] == "delta"
    assert man["delta"]["opt/memory"]["chunks"] == [5]
    _equal(mgr.restore()[1], state)


def test_delta_compaction_and_gc_keep_chain_restorable(tmp_path):
    mgr = tm.CheckpointManager(str(tmp_path), keep=2, delta=True,
                               compact_every=3)
    state = _pool_state(2)
    kinds = {}
    for i, s in enumerate(range(0, 30, 5)):
        state["params"]["memory"][i * 7] += 1.0
        state["step"] = np.asarray(s, np.int32)
        mgr.mark_dirty_slots([i * 7])
        mgr.save(s, state)
        kinds[s] = _manifest(tmp_path, s)["kind"]
    assert [kinds[s] for s in (0, 5, 10, 15, 20, 25)] == [
        "base", "delta", "delta", "delta", "base", "delta"]
    assert mgr.retained_steps() == [20, 25]
    _equal(mgr.restore()[1], state)
    assert mgr.restore(step=20)[0] == 20


def test_torn_delta_falls_back_to_intact_pair(tmp_path):
    d = str(tmp_path / "a")
    mgr = tm.CheckpointManager(d, keep=3, delta=True)
    state = _pool_state(3)
    mgr.save(0, state)
    state["params"]["memory"][10] += 1.0
    state["step"] = np.asarray(5, np.int32)
    mgr.save(5, state)
    want5 = {k: np.copy(v) for k, v in tm._flatten(state).items()}
    inj = tflt.FaultInjector("torn_ckpt@5:0.4", seed=0)
    inj.now = 10
    tflt.install(inj)
    state["params"]["memory"][CHUNK + 11] += 2.0
    state["step"] = np.asarray(10, np.int32)
    mgr.save(10, state)
    tflt.install(None)
    step, restored, rep = _both_restore(tmp_path, d)
    assert step == 5
    _equal(restored, tm._unflatten(want5))
    assert rep["fell_back_from"] == 10 and rep["torn_writes"] == 1
    mgr.restore()
    mgr.save(15, restored)
    assert mgr.restore()[0] == 15


def test_legacy_manifest_migrates_as_base(tmp_path):
    tm.CheckpointManager(str(tmp_path), keep=3).save(0, _pool_state(4))
    mpath = os.path.join(tmp_path, "step_0000000000", "manifest.json")
    man = _manifest(tmp_path, 0)
    del man["format"], man["kind"]
    with open(mpath, "w") as f:
        json.dump(man, f)
    mgr = tm.CheckpointManager(str(tmp_path), keep=3, delta=True)
    state = _pool_state(4)
    step, restored = mgr.restore()
    assert step == 0
    _equal(restored, state)
    state["params"]["memory"][3] += 1.0
    state["step"] = np.asarray(5, np.int32)
    mgr.save(5, state)
    man5 = _manifest(tmp_path, 5)
    assert man5["kind"] == "delta" and man5["base_step"] == 0
    _equal(mgr.restore()[1], state)


# ------------------------------------------------------ format, both ways

def _chain(mgr_cls, d, torn: bool):
    """base 0, delta 5, delta 10 (torn when asked), keep 3."""
    mgr = mgr_cls(d, keep=3, delta=True)
    state = _pool_state(6, m=4 * CHUNK + 100)
    mgr.save(0, state)
    states = {}
    for s, slot in ((5, CHUNK + 1), (10, 4 * CHUNK + 50)):
        state["params"]["memory"][slot] += 1.0
        state["opt"]["memory"][slot] = 0.5
        state["step"] = np.asarray(s, np.int32)
        mgr.mark_dirty_slots([slot])
        if torn and s == 10:
            inj = tflt.FaultInjector("torn_ckpt@1:0.3")
            jinj = jflt.FaultInjector("torn_ckpt@1:0.3")
            inj.now = jinj.now = 10
            tflt.install(inj)
            jflt.install(jinj)
        mgr.save(s, state)
        tflt.install(None)
        jflt.install(None)
        states[s] = {k: np.copy(v) for k, v in tm._flatten(state).items()}
    return states


@pytest.mark.parametrize("torn", [False, True])
@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_directories_restore_across_packages(tmp_path, writer, reader, torn):
    d = str(tmp_path / writer)
    states = _chain(MGR[writer], d, torn)
    other = str(tmp_path / "other")
    _chain(MGR[reader], other, torn)
    for s in (0, 5, 10):          # the same saves, the same manifests
        with open(os.path.join(d, f"step_{s:010d}", "manifest.json")) as f, \
                open(os.path.join(other, f"step_{s:010d}",
                                  "manifest.json")) as g:
            assert f.read() == g.read()
    rmgr = MGR[reader](d, keep=3, delta=True)
    step, tree = rmgr.restore()
    assert step == (5 if torn else 10)
    _equal(tree, tm._unflatten(states[step]))
    assert rmgr.last_restore_report["torn_writes"] == int(torn)
    step, tree = MGR[reader](d).restore(step=5)
    _equal(tree, tm._unflatten(states[5]))
