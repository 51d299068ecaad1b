"""Fault-tolerant checkpointing (port of ``repro.checkpoint.manager``):
atomic, versioned, async, healing and -- for memory-pool states --
incremental, in the reference's on-disk format byte for byte, so a
directory either package writes restores in the other.

Layout:  <dir>/step_<N>/{manifest.json, arrays.npz}   (+ LATEST marker file)

Guarantees:
  * atomicity -- every emitted file is written to a ``.part`` twin, fsynced
    and ``os.replace``d into place; the manifest lands *last* inside a
    ``.tmp-*`` directory that is renamed only once complete;
  * integrity -- the manifest (``FORMAT = 2``) carries per-leaf
    shape/dtype, a whole-tree sha256, a per-leaf sha256, and per-chunk bit
    sums for memory-pool leaves (paths whose last component is ``memory``;
    ``repro_torch.resilience.integrity``), all verified on restore;
  * incrementality -- with ``delta=True`` a save whose base is still on disk
    persists, per pool leaf, only the chunks dirtied since that base (the
    marked set from ``mark_dirty_slots`` unioned with a checksum diff
    against the base); non-pool leaves ride in full.  Deltas are
    cumulative-since-base; every ``compact_every`` deltas a full base is
    written again;
  * finite refusal -- ``save`` rejects a snapshot holding non-finite floats
    (``check_finite=False`` opts out);
  * self-healing restore -- a corrupt base with corruption confined to
    integrity-covered pool leaves is repaired by zeroing the mismatched
    chunks; a delta candidate restores as an intact (base, delta) pair or
    not at all; ``restore`` walks retained steps newest to oldest, counting
    the torn candidates it routed around;
  * retention -- the newest ``keep`` checkpoints plus the base each retained
    delta replays from;
  * async -- ``save(..., blocking=False)`` copies every leaf to host memory
    and plans the delta before it returns (the port's parameters and
    optimizer states are updated in place, so nothing may be read later);
    only the file writes run in the background thread.

Migration: manifests without ``format`` / ``kind`` keys are read as full
bases.  Leaves may be torch tensors (any device), numpy arrays or scalars
(a tiered run's full pools come from its host mirror as numpy arrays, its
``tier/hot_ids`` and ``tier/ema`` as int32 and float64); restore gives
numpy arrays of the dtypes saved.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.resilience import faults as faults_lib
from repro_torch.resilience import integrity as integ_lib

FORMAT = 2


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree.keys()):
            out.update(_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}/#{i}"))
        if len(tree) == 0:
            out[prefix + "/#empty"] = np.zeros((0,), np.int32)
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.startswith("#") for k in keys):
            if keys == ["#empty"]:
                return ()
            items = sorted(((int(k[1:]), rebuild(v)) for k, v in node.items()))
            return tuple(v for _, v in items)
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


def _host(v) -> np.ndarray:
    """A leaf as a host array: a tensor is copied off its device (or out of
    its CPU storage), so the snapshot cannot change under in-place updates
    made after ``save`` returns."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True).numpy()
    return np.asarray(v)


def _bytes(a: np.ndarray) -> np.ndarray:
    """``a``'s bytes as a flat uint8 view (what ``tobytes()`` would copy)."""
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _leaf_sha(a: np.ndarray) -> str:
    return hashlib.sha256(_bytes(a)).hexdigest()


def _pair_sha(ids: np.ndarray, payload: np.ndarray) -> str:
    """sha256 of ``ids.tobytes() + payload.tobytes()`` (a delta leaf)."""
    digest = hashlib.sha256(_bytes(ids))
    digest.update(_bytes(payload))
    return digest.hexdigest()


def _tree_digest(host: dict) -> str:
    digest = hashlib.sha256()
    for k in sorted(host):
        digest.update(k.encode())
        digest.update(_bytes(host[k]))
    return digest.hexdigest()


def _is_pool_leaf(path: str) -> bool:
    return path.split("/")[-1] == "memory"


def _atomic_file(path: str, writer, mode: str = "wb") -> None:
    """Write through a ``.part`` twin + fsync + ``os.replace`` -- the file is
    either absent or complete, never torn (the per-file layer of the
    crash-consistency contract; the step-directory rename is the outer
    layer)."""
    tmp = path + ".part"
    with open(tmp, mode) as f:
        writer(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _delta_chunk_slices(size: int, ids, chunk: int):
    """[(lo, hi)] element ranges of each dirty chunk in a flat [size] leaf;
    only the final chunk may be partial."""
    out = []
    for i in ids:
        lo = int(i) * chunk
        out.append((lo, min(lo + chunk, size)))
    return out


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, delta: bool = False,
                 compact_every: int = 8):
        self.dir = directory
        self.keep = keep
        self.delta = bool(delta)
        self.compact_every = max(int(compact_every), 1)
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None   # a failed async write
        # what healing the most recent restore performed:
        # {"quarantined_chunks": int, "repaired_leaves": [..],
        #  "fell_back_from": step|None, "torn_writes": int, "chain_len": int}
        self.last_restore_report: dict = {}
        # --- delta-chain state (committed at the end of _write / restore) ---
        self._base_step: int | None = None     # current chain's base on disk
        self._base_sums: dict[str, np.ndarray] = {}   # pool chunk sums @ base
        self._base_leafmeta: dict = {}         # full leaves dict @ base
        self._dirty_chunks: set[int] = set()   # marked since the base
        self._last_step: int | None = None     # newest durable step we know
        self.chain_len = 0                     # deltas since the base
        self.last_saved_step: int | None = None
        self.bytes_written = 0                 # cumulative array payload bytes
        self.last_save_bytes = 0               # payload bytes of the last save
        # host seconds of the last save: "snapshot" (the synchronous copy to
        # the host, finite check and plan) and "write" (the files, in the
        # background thread for an async save); of the last restore
        self.last_save_seconds: dict = {}
        self.last_restore_seconds = 0.0

    # ------------------------------------------------------------ dirty set
    def mark_dirty_slots(self, slots) -> None:
        """Record pool slots touched since the current base checkpoint (each
        step's ``SparseGrad`` indices, or a tiered run's planned global
        locations).  Slots are global pool element
        indices; negatives (skip sentinels) are ignored, indices past a
        leaf's end are clipped at save time.  A tensor is reduced to its
        chunk ids on its own device, so only those cross to the host.  No-op
        unless this manager was built with ``delta=True``."""
        if not self.delta:
            return
        if isinstance(slots, torch.Tensor):
            s = slots.reshape(-1)
            if s.numel():
                c = torch.unique(torch.div(s.long(), integ_lib.CHUNK,
                                           rounding_mode="floor"))
                self._dirty_chunks.update(
                    int(i) for i in c.cpu().numpy() if i >= 0)
            return
        s = np.asarray(slots).reshape(-1)
        if s.size == 0:
            return
        s = s[s >= 0]
        if s.size:
            self._dirty_chunks.update(
                int(c) for c in np.unique(s // integ_lib.CHUNK))

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree, blocking: bool = True,
             check_finite: bool = True) -> None:
        self.wait()  # serialize with any in-flight async write
        if os.path.exists(os.path.join(self.dir, f"step_{step:010d}",
                                       "manifest.json")):
            # idempotent: this step is already durably saved.  Re-anchor the
            # chain on it (the resume-after-preempt double-save path).
            if self._last_step != step:
                try:
                    with open(os.path.join(self.dir, f"step_{step:010d}",
                                           "manifest.json")) as f:
                        self._adopt(step, json.load(f))
                except (OSError, ValueError):
                    pass
            return
        t0 = time.perf_counter()
        host = {k: _host(v) for k, v in _flatten(tree).items()}
        if check_finite:
            # refuse to persist poison -- synchronously, so the caller sees
            # the error even for async saves
            for k, v in host.items():
                if (np.issubdtype(v.dtype, np.floating)
                        and not np.isfinite(v).all()):
                    raise ValueError(
                        f"refusing to persist non-finite state at {k!r} "
                        f"(step {step}); pass check_finite=False to override")
        plan = self._plan(step, host)
        # the injected torn write is drawn here, not in the writer thread,
        # so which save it tears does not depend on the thread's timing
        plan["torn"] = faults_lib.torn_ckpt()
        if plan["mode"] == "base":
            # a base captures everything: dirty marks restart from it.  A
            # failed base write only costs re-diffing against the unchanged
            # old base on the next save (the checksum diff re-derives dirty).
            self._dirty_chunks = set()
        self.last_save_seconds = {"snapshot": time.perf_counter() - t0}
        if blocking:
            self._write(step, host, plan)
        else:
            self._thread = threading.Thread(
                target=self._write_async, args=(step, host, plan),
                daemon=True)
            self._thread.start()

    def _write_async(self, step: int, host: dict, plan: dict):
        try:
            self._write(step, host, plan)
        except BaseException as e:  # noqa: BLE001 -- re-raised by wait()
            self._error = e

    def wait(self):
        """Join an in-flight async write; a write that failed raises here."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def _plan(self, step: int, host: dict) -> dict:
        """Decide base-vs-delta and precompute everything that reads the
        manager's mutable chain state -- runs synchronously in ``save`` so
        the background writer only touches files."""
        pool = sorted(k for k in host if _is_pool_leaf(k))
        sums = {k: integ_lib.np_chunk_checksums(host[k]) for k in pool}
        leaves = {k: {"shape": list(host[k].shape),
                      "dtype": str(host[k].dtype),
                      "sha256": _leaf_sha(host[k])}
                  for k in sorted(host)}
        integrity = {k: {"chunk": integ_lib.CHUNK,
                         "checksums": [int(c) for c in sums[k]]}
                     for k in pool}
        plan = {"mode": "base", "sums": sums, "leaves": leaves,
                "integrity": integrity, "chain_len": 0,
                "base_step": None, "dirty": {}}
        if not (self.delta and pool and self._base_step is not None
                and self.chain_len < self.compact_every):
            return plan
        bm = self._base_leafmeta
        compatible = (set(bm) == set(leaves)
                      and all(bm[k]["shape"] == leaves[k]["shape"]
                              and bm[k]["dtype"] == leaves[k]["dtype"]
                              for k in bm)
                      and all(k in self._base_sums for k in pool)
                      and os.path.exists(os.path.join(
                          self.dir, f"step_{self._base_step:010d}",
                          "manifest.json")))
        if not compatible:
            return plan
        dirty = {}
        for k in pool:
            n_chunks = int(sums[k].shape[0])
            changed = set(np.nonzero(sums[k] != self._base_sums[k])[0]
                          .tolist())
            # union: marked dirty (the training-side feed) OR checksum-diff
            # vs the base (the safety net that catches unmarked mutations --
            # quarantine repair, dense-moment drift, rot)
            changed.update(i for i in self._dirty_chunks if i < n_chunks)
            dirty[k] = np.asarray(sorted(changed), np.int32)
        plan.update(mode="delta", dirty=dirty, chain_len=self.chain_len + 1,
                    base_step=self._base_step)
        return plan

    def _write(self, step: int, host: dict, plan: dict):
        t0 = time.perf_counter()
        final = os.path.join(self.dir, f"step_{step:010d}")
        tmp = os.path.join(self.dir, f".tmp-step_{step:010d}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {
            "format": FORMAT,
            "kind": plan["mode"],
            "step": step,
            "checksum": _tree_digest(host),
            "leaves": plan["leaves"],
            "integrity": plan["integrity"],
        }
        if plan["mode"] == "base":
            arrays = dict(host)
            nbytes = int(sum(v.nbytes for v in host.values()))
        else:
            # delta payload: non-pool leaves in full, pool leaves as
            # (chunk ids, concatenated dirty-chunk values) pairs --
            # cumulative since the base, each pair independently verifiable
            arrays = {k: v for k, v in host.items() if not _is_pool_leaf(k)}
            delta_meta = {}
            nbytes = int(sum(v.nbytes for v in arrays.values()))
            for k, ids in plan["dirty"].items():
                leaf = np.ascontiguousarray(host[k]).reshape(-1)
                slices = _delta_chunk_slices(leaf.size, ids, integ_lib.CHUNK)
                payload = (np.concatenate([leaf[lo:hi] for lo, hi in slices])
                           if slices else np.zeros((0,), leaf.dtype))
                arrays[k + "@chunks"] = ids
                arrays[k + "@delta"] = payload
                delta_meta[k] = {
                    "chunk": integ_lib.CHUNK,
                    "chunks": [int(i) for i in ids],
                    "sha256": _pair_sha(ids, payload),
                    "checksums": [int(plan["sums"][k][i]) for i in ids],
                }
                nbytes += int(ids.nbytes + payload.nbytes)
            manifest["base_step"] = plan["base_step"]
            manifest["delta"] = delta_meta
        _atomic_file(os.path.join(tmp, "arrays.npz"),
                     lambda f: np.savez(f, **arrays))
        # manifest last: its presence asserts every other file is complete
        _atomic_file(os.path.join(tmp, "manifest.json"),
                     lambda f: json.dump(manifest, f), mode="w")
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        _atomic_file(os.path.join(self.dir, "LATEST"),
                     lambda f: f.write(os.path.basename(final)), mode="w")
        # injected torn write: payload loss that survives the rename (lying
        # storage / post-crash page loss) -- exercises the restore ladder
        frac = plan.get("torn")
        if frac is not None:
            p = os.path.join(final, "arrays.npz")
            with open(p, "rb+") as f:
                f.truncate(max(int(os.path.getsize(p) * frac), 1))
        self._gc()
        # commit the chain bookkeeping (save() wait()s before reading these)
        self.bytes_written += nbytes
        self.last_save_bytes = nbytes
        self.last_saved_step = step
        self._last_step = step
        if plan["mode"] == "base":
            self._base_step = step
            self._base_leafmeta = plan["leaves"]
            self._base_sums = plan["sums"]
            self.chain_len = 0
        else:
            self.chain_len = plan["chain_len"]
        self.last_save_seconds["write"] = time.perf_counter() - t0

    def _adopt(self, step: int, manifest: dict):
        """Re-anchor the delta chain on a durable step found on disk (a
        restore, or an idempotent re-save) so the next incremental save
        diffs against exactly the state we resumed from."""
        self._last_step = step

        def read_sums(m):
            return {k: np.asarray(v["checksums"], np.uint32)
                    for k, v in m.get("integrity", {}).items()}

        if manifest.get("kind") == "delta":
            base_step = manifest.get("base_step")
            try:
                with open(os.path.join(self.dir, f"step_{base_step:010d}",
                                       "manifest.json")) as f:
                    bm = json.load(f)
            except (OSError, TypeError, ValueError):
                # base gone: the next save is forced to start a new base
                self._base_step = None
                self.chain_len = 0
                self._dirty_chunks = set()
                return
            self._base_step = base_step
            self._base_leafmeta = bm.get("leaves", {})
            self._base_sums = read_sums(bm)
            self.chain_len = max(self.chain_len, 1)
            # known-dirty-since-base: the adopted delta's own chunk set (the
            # checksum diff re-derives the rest on every save)
            self._dirty_chunks = {
                int(i) for info in manifest.get("delta", {}).values()
                for i in info.get("chunks", [])}
        else:
            self._base_step = step
            self._base_leafmeta = manifest.get("leaves", {})
            self._base_sums = read_sums(manifest)
            self.chain_len = 0
            self._dirty_chunks = set()

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir) if d.startswith("step_"))
        if not self.keep:
            return
        needed = set(steps[-self.keep:])
        # a retained delta is only restorable with its base: pin it too
        for name in list(needed):
            mpath = os.path.join(self.dir, name, "manifest.json")
            try:
                with open(mpath) as f:
                    m = json.load(f)
            except (OSError, ValueError):
                continue
            if m.get("kind") == "delta" and m.get("base_step") is not None:
                needed.add(f"step_{m['base_step']:010d}")
        for d in steps:
            if d not in needed:
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # -------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        marker = os.path.join(self.dir, "LATEST")
        if not os.path.exists(marker):
            return None
        with open(marker) as f:
            name = f.read().strip()
        if not os.path.exists(os.path.join(self.dir, name, "manifest.json")):
            # marker points at a deleted/corrupt dir: fall back to newest valid
            cands = sorted(d for d in os.listdir(self.dir)
                           if d.startswith("step_") and os.path.exists(
                               os.path.join(self.dir, d, "manifest.json")))
            if not cands:
                return None
            name = cands[-1]
        return int(name.split("_")[1])

    def retained_steps(self) -> list[int]:
        """Steps with an on-disk manifest, ascending."""
        out = []
        for d in sorted(os.listdir(self.dir)):
            if d.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, d, "manifest.json")):
                out.append(int(d.split("_")[1]))
        return out

    def restore(self, step: int | None = None, shardings=None,
                verify: bool = True, fallback: bool = True):
        """-> (step, tree of host arrays).  ``shardings``: ``(path, array)
        -> array``, applied to every leaf after verification: the elastic
        re-shard onto the current mesh (the reference's ``shardings``
        places each leaf with a ``device_put``; a rank here keeps its part,
        ``repro_torch.dist.sharding.slab_shardings``, and the caller copies
        it where it belongs).  The checkpoint itself holds whole arrays, so
        it restores onto any mesh.

        With ``step=None`` (the resume path) a latest checkpoint that fails
        to read or verify is not fatal: after attempting chunk-level repair
        (full/base candidates; see ``_read_step``), restore walks the
        previously retained steps newest-to-oldest and returns the first
        healthy one, recording the skip in
        ``last_restore_report["fell_back_from"]`` and counting the torn /
        corrupt candidates it routed around in ``["torn_writes"]``.  A delta
        candidate replays its intact (base, delta) pair or raises -- deltas
        are never partially merged, so every restore is from an intact
        chain.  An explicitly requested ``step`` never falls back -- the
        caller asked for those exact bytes.  A successful restore re-anchors
        this manager's delta chain at the restored step.
        """
        t0 = time.perf_counter()
        explicit = step is not None
        if explicit:
            candidates = [step]
        else:
            latest = self.latest_step()
            if latest is None:
                raise FileNotFoundError(f"no checkpoint in {self.dir}")
            candidates = [latest]
            if fallback:
                candidates += [s for s in reversed(self.retained_steps())
                               if s < latest]
        errors = []
        for i, s in enumerate(candidates):
            try:
                got, tree, report, manifest = self._read_step(
                    s, shardings, verify)
            except Exception as e:  # noqa: BLE001 -- any unreadable candidate
                if explicit or not fallback:
                    raise
                errors.append(f"step {s}: {type(e).__name__}: {e}")
                continue
            report["fell_back_from"] = (candidates[0]
                                        if s != candidates[0] else None)
            # candidates skipped on the way down are detected torn/corrupt
            # writes (the health counter the trainer surfaces)
            report["torn_writes"] = report.get("torn_writes", 0) + i
            self.last_restore_report = report
            self._adopt(got, manifest)
            self.last_restore_seconds = time.perf_counter() - t0
            return got, tree
        raise IOError("no restorable checkpoint in "
                      f"{self.dir}:\n  " + "\n  ".join(errors))

    def _read_step(self, step: int, shardings, verify: bool):
        path = os.path.join(self.dir, f"step_{step:010d}")
        if faults_lib.io_fault():
            raise IOError(f"injected host read failure for {path}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        report = {"quarantined_chunks": 0, "repaired_leaves": [],
                  "torn_writes": 0, "chain_len": 0}
        if manifest.get("kind") == "delta":
            host = self._read_delta(step, manifest, report)
            if verify and _tree_digest(host) != manifest["checksum"]:
                # a delta candidate is all-or-nothing: a digest miss after a
                # verified replay means base-content drift -- repairing it
                # chunk-by-chunk would silently merge two timelines
                raise IOError(f"checkpoint {path}: replayed (base, delta) "
                              "state failed checksum verification")
        else:
            with np.load(os.path.join(path, "arrays.npz")) as z:
                host = {k: z[k] for k in z.files}
            if verify and _tree_digest(host) != manifest["checksum"]:
                self._chunk_repair(host, manifest, report, path)
        if shardings is not None:
            host = {k: shardings(k, v) for k, v in host.items()}
        return manifest["step"], _unflatten(host), report, manifest

    def _read_delta(self, step: int, manifest: dict, report: dict) -> dict:
        """Replay (base, this delta).  Strict: any unreadable or
        unverifiable piece raises -- the fallback ladder then lands on the
        newest intact candidate instead of merging a torn write."""
        base_step = manifest.get("base_step")
        if base_step is None:
            raise IOError(f"delta manifest at step {step} lacks base_step")
        try:
            with np.load(os.path.join(self.dir, f"step_{base_step:010d}",
                                      "arrays.npz")) as z:
                host = {k: z[k] for k in z.files}
        except Exception as e:
            raise IOError(f"base step {base_step} for delta step {step} is "
                          f"unreadable: {type(e).__name__}: {e}")
        try:
            with np.load(os.path.join(
                    self.dir, f"step_{step:010d}", "arrays.npz")) as z:
                data = {k: z[k] for k in z.files}
        except Exception as e:
            raise IOError(f"delta payload for step {step} is torn/"
                          f"unreadable: {type(e).__name__}: {e}")
        for k, v in data.items():
            if "@" not in k:               # non-pool leaf, stored in full
                host[k] = v
        for k, info in manifest.get("delta", {}).items():
            self._apply_delta_leaf(host, k, info, data, step)
        report["chain_len"] = 1
        return host

    def _apply_delta_leaf(self, host: dict, k: str, info: dict, data: dict,
                          step: int):
        ids_key, pay_key = k + "@chunks", k + "@delta"
        if ids_key not in data or pay_key not in data or k not in host:
            raise IOError(f"delta payload for step {step} lacks {k!r} "
                          "chunk arrays")
        ids = np.asarray(data[ids_key], np.int32)
        payload = np.asarray(data[pay_key])
        chunk = int(info.get("chunk", integ_lib.CHUNK))
        leaf = np.ascontiguousarray(host[k]).reshape(-1).copy()
        slices = _delta_chunk_slices(leaf.size, ids, chunk)
        expect = sum(hi - lo for lo, hi in slices)
        if (payload.size != expect
                or [int(i) for i in ids] != info.get("chunks")
                or (ids.size and (int(ids.min()) < 0
                                  or int(ids.max()) * chunk >= leaf.size))):
            raise IOError(f"delta payload for step {step}, leaf {k!r}: "
                          "chunk layout mismatch (torn write)")
        if _pair_sha(ids, payload) != info.get("sha256"):
            # localize before giving up: the per-chunk bit sums name the
            # first corrupt chunk in the error (operator-debuggable), but
            # the candidate is still rejected as a whole
            ref = info.get("checksums") or []
            off = 0
            for j, (lo, hi) in enumerate(slices):
                piece = payload[off: off + (hi - lo)]
                off += hi - lo
                got = integ_lib.np_chunk_checksums(piece, chunk)
                if j >= len(ref) or int(got[0]) != int(ref[j]):
                    raise IOError(
                        f"delta payload for step {step}, leaf {k!r}: chunk "
                        f"{int(ids[j])} failed its bit-sum check")
            raise IOError(f"delta payload for step {step}, leaf {k!r} "
                          "failed sha256 verification")
        off = 0
        for lo, hi in slices:
            leaf[lo:hi] = payload[off: off + (hi - lo)]
            off += hi - lo
        host[k] = leaf.reshape(host[k].shape)

    def _chunk_repair(self, host: dict, manifest: dict, report: dict,
                      path: str):
        """Whole-tree checksum failed: localize, and repair in place iff
        every corrupt leaf is integrity-covered (a memory pool, where zeroed
        chunks degrade gracefully).  Raises IOError when the corruption is
        unrepairable -- the caller then falls back to an older step."""
        leaves = manifest.get("leaves", {})
        integrity = manifest.get("integrity", {})
        if set(host) != set(leaves):
            raise IOError(f"checkpoint {path} failed checksum verification "
                          "(leaf set mismatch)")
        bad = [k for k in sorted(host)
               if leaves[k].get("sha256") not in (None, _leaf_sha(host[k]))]
        if any(leaves[k].get("sha256") is None for k in sorted(host)):
            # legacy manifest without per-leaf hashes: cannot localize
            raise IOError(f"checkpoint {path} failed checksum verification")
        if not bad:
            raise IOError(f"checkpoint {path} failed checksum verification "
                          "(corruption outside array payload)")
        for k in bad:
            info = integrity.get(k)
            if info is None:
                raise IOError(f"checkpoint {path}: leaf {k!r} is corrupt and "
                              "not integrity-covered; unrepairable")
            got = integ_lib.np_chunk_checksums(host[k], info["chunk"])
            ref = np.asarray(info["checksums"], np.uint32)
            if got.shape != ref.shape:
                raise IOError(f"checkpoint {path}: leaf {k!r} chunk layout "
                              "mismatch; unrepairable")
            bad_chunks = got != ref
            if not bad_chunks.any():
                raise IOError(f"checkpoint {path}: leaf {k!r} sha mismatch "
                              "but chunks verify; unrepairable")
            host[k] = integ_lib.np_quarantine_chunks(
                host[k], bad_chunks, info["chunk"])
            report["quarantined_chunks"] += int(bad_chunks.sum())
            report["repaired_leaves"].append(k)
