"""Tiered memory store: HBM-hot / host-cold pools for over-budget memory
(port of ``repro.tier.store``).

The pool M is one flat [m] vector.  When it (with its optimizer moments)
exceeds a per-device budget, :class:`TieredStore` splits its storage:

  * the pool is divided into fixed ``block``-slot **tier blocks**;
  * **host memory holds the full pool** (numpy, one [n_blocks, block]
    mirror per leaf);
  * the ``hot_blocks`` most-touched blocks are **resident on the device**
    as one compact slab, sorted by block id (membership is a binary
    search);
  * the cold blocks a batch touches are **staged** before the step: the
    rows are gathered into one of two pinned host buffers and copied to the
    device on a side CUDA stream (``non_blocking``); ``install`` makes the
    current stream wait on that copy's event, then copies the rows into
    the compact leaves' stage regions;
  * between steps an **EMA of observed per-block touch counts** promotes
    and demotes blocks, moving value rows and optimizer-moment rows
    verbatim (bit-exact).

A leaf's compact pool is ``[(hot_blocks + stage_blocks) * block]``: the
slab ``[:hot_slots]`` is authoritative for hot blocks, the stage region for
the staged cold blocks, the host mirror for everything else.  Its size
never changes, so ``install`` and ``retier`` write into the live compact
tensors in place (under ``no_grad``): the model's parameter, the Trainer's
``params`` and the optimizer state keep their tensors.
:func:`remap_locations` turns a scheme's global pool locations into
compact-pool indices, so ``compact[remap(loc)]`` is bit-identical to
``full[loc]`` whenever staging covered the batch, which the
:class:`~repro_torch.tier.training.TierController` guarantees by planning
the stage set from the same location math.

The host mirror and the EMA stay numpy (float64 EMA), as in the reference;
``touched_blocks`` runs on its input's device, so only a step's distinct
blocks and their counts cross to the host.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from repro_torch.device import resolve_device

BLOCK_DEFAULT = 512          # slots per tier block (= store_rows granularity)
EMA_DECAY = 0.8              # per-observation decay of the touch-count EMA


class StageTransferError(RuntimeError):
    """A host->device staging transfer failed (injected or real).  Staging
    has no side effect until :meth:`TieredStore.install` consumes it, so the
    controller simply retries the stage."""


# ----------------------------------------------------------- budget helpers

def tier_budget_mb() -> float | None:
    """Per-device HBM budget for the pool, from ``REPRO_TIER_BUDGET_MB``
    (the env twin of ``launch/train.py --tier-budget-mb``); None = untiered."""
    v = os.environ.get("REPRO_TIER_BUDGET_MB", "").strip()
    return float(v) if v else None


def budget_slots(budget_mb: float, itemsize: int = 4,
                 block: int = BLOCK_DEFAULT) -> int:
    """How many pool slots a per-device budget admits, floored to whole
    blocks: the raw capacity that :func:`tier_split` divides across the
    compact leaves and their stage regions."""
    slots = int(budget_mb * 2**20 / itemsize)
    return (slots // block) * block


def tier_split(m: int, budget_mb: float | None, itemsize: int = 4,
               block: int = BLOCK_DEFAULT, n_leaves: int = 1,
               stage_blocks: int = 0) -> tuple[int, int]:
    """(hot_slots, cold_slots) for an [m]-slot pool under ``budget_mb``.

    The budget bounds the pool's whole device footprint: ``n_leaves``
    compact leaves (the value pool and its optimizer-moment mirrors, all of
    one size), each with a ``stage_blocks``-block stage region.  Each leaf
    gets ``budget / n_leaves`` slots, staging is carved out first, and the
    hot slab keeps the rest.  ``None``, or a budget the whole
    ``n_leaves * m`` footprint fits, keeps everything hot (no stage
    region)."""
    if budget_mb is None:
        return m, 0
    per_leaf = budget_slots(budget_mb, itemsize, block) // max(int(n_leaves),
                                                               1)
    if per_leaf >= m:
        return m, 0
    hot = (max(per_leaf - int(stage_blocks) * block, 0) // block) * block
    return hot, m - hot


def needs_tiering(m: int, itemsize: int = 4,
                  budget_mb: float | None = None, n_leaves: int = 1) -> bool:
    """Does an [m]-slot pool (times ``n_leaves`` same-sized compact leaves)
    exceed the per-device budget?"""
    budget_mb = tier_budget_mb() if budget_mb is None else budget_mb
    return tier_split(m, budget_mb, itemsize, n_leaves=n_leaves)[1] > 0


# ------------------------------------------------------- location remapping

def remap_locations(loc: torch.Tensor, hot_ids: torch.Tensor,
                    stage_ids: torch.Tensor, block) -> torch.Tensor:
    """Global pool locations -> compact tiered-pool indices (int32), on the
    locations' device.

    ``hot_ids`` [H] / ``stage_ids`` [S]: sorted int32 block ids (stage
    padded with the ``n_blocks`` sentinel, which sorts after every real id);
    ``block`` an int or a 0-dim tensor.  A location in block ``b`` maps to
    ``rank_of(b) * block + offset`` in ``concat(hot slab, stage slab)``, so
    ``compact[remap(loc)] == full[loc]`` bitwise for every location whose
    block is hot or staged.  A location in an unstaged cold block has no
    defined image (the controller stages every block a step touches)."""
    shape = loc.shape
    flat = loc.reshape(-1).to(torch.int32)
    blk = torch.as_tensor(block, dtype=torch.int32,
                          device=flat.device).reshape(())
    b = torch.div(flat, blk, rounding_mode="floor")
    off = flat - b * blk
    H, S = int(hot_ids.shape[0]), int(stage_ids.shape[0])
    if H:
        hpos = torch.searchsorted(hot_ids, b, out_int32=True).clamp_(0, H - 1)
        is_hot = hot_ids[hpos.long()] == b
    else:
        hpos = torch.zeros_like(b)
        is_hot = torch.zeros(b.shape, dtype=torch.bool, device=b.device)
    if S:
        spos = torch.searchsorted(stage_ids, b,
                                  out_int32=True).clamp_(0, S - 1)
    else:
        spos = torch.zeros_like(b)
    row = torch.where(is_hot, hpos, H + spos)
    return (row * blk + off).reshape(shape)


# ----------------------------------------------------------------- the store

def _host_array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class TieredStore:
    """Host-authoritative full pool + device-resident hot slab + stage slots.

    One store manages several same-shaped pool *leaves* (the value pool
    ``"memory"`` and the optimizer-moment leaves that mirror it, named
    ``"opt:<path>"`` by the controller); all share one block layout, so
    promotion and demotion move value rows and their moments together.

    The per-step protocol (driven by
    :class:`~repro_torch.tier.training.TierController`):

        writeback(tree)          # staged rows of step N-1 -> host
        retier(tree)             # optional: EMA promote/demote, in place
        stage(blocks)            # gather + async host->device copy
        install(tree)            # stage region <- staged rows, in place
    """

    def __init__(self, memory, budget_slots_or_hot: int,
                 block: int = BLOCK_DEFAULT, stage_blocks: int | None = None,
                 counts=None, ema_decay: float = EMA_DECAY, device=None):
        """``memory``: the full [m] initial pool (a tensor, or a numpy
        array).  ``budget_slots_or_hot``: hot-tier size in slots (floored to
        blocks).  ``stage_blocks``: the staging capacity, the most cold
        blocks one step may touch; left out, every cold block is stageable,
        which makes the compact pool as large as the full pool (no HBM
        saved), so it warns.  ``counts``: optional [n_blocks] observed touch
        counts seeding the hot set (default: the pool head).  ``device``:
        where the compact leaves live; default the tensor's device, and the
        card for a numpy pool."""
        mem = _host_array(memory)
        if mem.ndim != 1:
            raise ValueError("TieredStore manages flat [m] pools")
        if device is None and isinstance(memory, torch.Tensor):
            device = memory.device
        self.device = resolve_device(device)
        self.m = int(mem.shape[0])
        self.block = int(block)
        if self.m % self.block:
            raise ValueError(f"pool size {self.m} must tile into "
                             f"{self.block}-slot blocks")
        self.n_blocks = self.m // self.block
        self.dtype = mem.dtype
        hot_blocks = min(self.n_blocks,
                         max(int(budget_slots_or_hot) // self.block, 0))
        self.hot_blocks = hot_blocks
        cold = self.n_blocks - hot_blocks
        if stage_blocks is None and cold:
            warnings.warn(
                f"TieredStore: stage_blocks defaulted to every cold block "
                f"({cold}); the compact pool then spans the full {self.m}"
                f"-slot pool and tiering saves no HBM -- pass a batch-derived "
                f"staging bound", stacklevel=2)
        self.stage_blocks = cold if stage_blocks is None \
            else max(min(int(stage_blocks), cold), 1 if cold else 0)
        self.ema = np.zeros(self.n_blocks, np.float64)
        if counts is not None:
            c = np.asarray(counts, np.float64)
            if c.shape != (self.n_blocks,):
                raise ValueError(f"counts {c.shape} for {self.n_blocks} "
                                 "blocks")
            self.ema = c.copy()
            order = np.lexsort((np.arange(self.n_blocks), -c))
            self.hot_ids = np.sort(order[:hot_blocks]).astype(np.int32)
        else:
            self.hot_ids = np.arange(hot_blocks, dtype=np.int32)
        self.ema_decay = float(ema_decay)
        # host mirror: the full pool, per leaf; hot blocks' rows go stale
        # while device-resident (retier refreshes them)
        self._host: dict[str, np.ndarray] = {
            "memory": mem.reshape(self.n_blocks, self.block).copy()}
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        # per leaf: two pinned host staging buffers, the device buffer the
        # staged rows land in, and a pinned write-back buffer
        self._hbuf: dict[str, list[torch.Tensor]] = {}
        self._dbuf: dict[str, torch.Tensor] = {}
        self._wbuf: dict[str, torch.Tensor] = {}
        self._read_done: list = [None, None]   # last copy out of each buffer
        self._flip = 0
        self._pending_ids: np.ndarray | None = None   # [S], sentinel pad
        self._pending_n = 0
        self._pending_event = None
        self._staged_ids: np.ndarray | None = None    # real ids of live stage
        self._stage_ids_dev = self._sentinel_ids()
        self._hot_dev = (None, None)            # (hot_ids array, its upload)
        self._block_dev = torch.tensor(self.block, dtype=torch.int32,
                                       device=self.device)
        self.stats = {"host_fetch_bytes": 0, "writeback_bytes": 0,
                      "staged_blocks": 0, "stage_steps": 0,
                      "promoted": 0, "demoted": 0,
                      "quarantined_cold_chunks": 0, "stage_retries": 0}

    # ------------------------------------------------------------ geometry
    @property
    def hot_slots(self) -> int:
        return self.hot_blocks * self.block

    @property
    def stage_slots(self) -> int:
        return max(self.stage_blocks, 1) * self.block

    @property
    def compact_slots(self) -> int:
        return self.hot_slots + self.stage_slots

    @property
    def cold_blocks(self) -> int:
        return self.n_blocks - self.hot_blocks

    @property
    def compact_bytes(self) -> int:
        """Device bytes of the compact leaves registered so far."""
        return sum(self.compact_slots * h.dtype.itemsize
                   for h in self._host.values())

    def _sentinel_ids(self) -> torch.Tensor:
        return torch.full((max(self.stage_blocks, 1),), self.n_blocks,
                          dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------- leaves
    def register_leaf(self, name: str, leaf) -> None:
        """Adopt an optimizer-moment leaf mirroring the pool.  The compact
        leaf must still hold one uniform value (a fresh optimizer init): the
        host mirror is filled with it, so the cold tier's moments start
        where the resident run's do."""
        if name in self._host:
            return
        t = torch.as_tensor(leaf)
        lo, hi = (float(v) for v in torch.aminmax(t.detach()))
        if lo != hi:
            raise ValueError(
                f"pool leaf {name!r} must be uniform at registration "
                f"(fresh optimizer init); got range [{lo}, {hi}]")
        dtype = _host_array(t[:1]).dtype
        self._host[name] = np.full((self.n_blocks, self.block), lo, dtype)

    def _register_tree(self, tree: dict) -> None:
        for name, leaf in tree.items():
            if name not in self._host:
                self.register_leaf(name, leaf)

    # ----------------------------------------------------- compact <-> full
    def initial_compact(self, name: str = "memory") -> torch.Tensor:
        """The leaf's initial compact pool on the store's device: the hot
        slab from the host mirror, the stage region zeroed (install
        overwrites it before any lookup)."""
        host = self._host[name]
        out = torch.zeros(self.compact_slots, dtype=_torch_dtype(host.dtype),
                          device=self.device)
        out[: self.hot_slots] = torch.from_numpy(
            host[self.hot_ids].reshape(-1)).to(self.device)
        return out

    def full_pool(self, compact, name: str = "memory") -> np.ndarray:
        """The full [m] pool a resident run would hold: the host mirror
        overlaid with the live hot slab and staged rows.  Bit-exact (row
        copies); the export path for eval and checkpoints."""
        out = self._host[name].copy()
        n = 0 if self._staged_ids is None else int(self._staged_ids.size)
        live = _host_array(torch.as_tensor(compact).detach()[
            : self.hot_slots + n * self.block])
        out[self.hot_ids] = live[: self.hot_slots].reshape(
            self.hot_blocks, self.block)
        if n:
            out[self._staged_ids] = live[self.hot_slots:].reshape(
                n, self.block)
        return out.reshape(-1)

    # --------------------------------------------------------- durability
    def set_host_full(self, name: str, full) -> None:
        """Overwrite a leaf's host mirror from a full [m] pool (the restore
        path: a checkpointed full pool becomes the mirror).  Registers the
        leaf if unseen; its value need not be uniform."""
        arr = _host_array(full).reshape(-1)
        if arr.shape[0] != self.m:
            raise ValueError(f"{name}: {arr.shape[0]} slots for a "
                             f"{self.m}-slot pool")
        self._host[name] = arr.reshape(self.n_blocks, self.block).copy()

    def tier_meta(self) -> dict:
        """What a checkpoint must carry besides the pools: the hot set
        (int32) and the touch-count EMA (float64).  Staging is per-step and
        left out: a restore replans it from the resumed batch stream."""
        return {"hot_ids": self.hot_ids.astype(np.int32).copy(),
                "ema": self.ema.copy()}

    def restore_meta(self, hot_ids=None, ema=None) -> None:
        """Adopt checkpointed tier meta.  When the checkpoint's geometry no
        longer matches (another budget), the hot set is re-derived from the
        EMA, as the constructor seeds it."""
        if ema is not None:
            e = np.asarray(ema, np.float64).reshape(-1)
            if e.shape[0] == self.n_blocks:
                self.ema = e.copy()
        h = None if hot_ids is None else np.asarray(hot_ids).reshape(-1)
        if (h is not None and h.shape[0] == self.hot_blocks
                and (h >= 0).all() and (h < self.n_blocks).all()):
            self.hot_ids = np.sort(h).astype(np.int32)
            return
        order = np.lexsort((np.arange(self.n_blocks), -self.ema))
        self.hot_ids = np.sort(order[: self.hot_blocks]).astype(np.int32)

    def drop_stage(self) -> None:
        """Discard staged and in-flight rows without touching the mirror
        (the rollback path: the restored state is authoritative)."""
        self._pending_ids = None
        self._pending_n = 0
        self._pending_event = None
        self._staged_ids = None
        self._stage_ids_dev = self._sentinel_ids()

    # ------------------------------------------------------- device buffers
    def batch_tier_buffers(self) -> dict:
        """The three remap buffers of this step, on the store's device, to
        ride in the batch: the hot ids (uploaded again only after the hot
        set changed), the live stage ids and the block size."""
        if self._hot_dev[0] is not self.hot_ids:
            self._hot_dev = (self.hot_ids, torch.from_numpy(
                self.hot_ids).to(self.device))
        return {"tier_hot_ids": self._hot_dev[1],
                "tier_stage_ids": self._stage_ids_dev,
                "tier_block": self._block_dev}

    # ------------------------------------------------------------- planning
    def touched_blocks(self, locations) -> tuple[np.ndarray, np.ndarray]:
        """Unique (block ids, touch counts) of a location set, as
        ``np.unique(loc // block, return_counts=True)`` gives them.  A
        tensor is reduced on its own device; only the result crosses."""
        if isinstance(locations, torch.Tensor):
            blocks, counts = torch.unique(
                torch.div(locations.reshape(-1), self.block,
                          rounding_mode="floor"),
                sorted=True, return_counts=True)
            return blocks.cpu().numpy(), counts.cpu().numpy()
        loc = np.asarray(locations).reshape(-1)
        return np.unique(loc // self.block, return_counts=True)

    def observe(self, blocks: np.ndarray, counts: np.ndarray) -> None:
        """Fold one step's touches into the EMA (the re-tier signal)."""
        self.ema *= self.ema_decay
        np.add.at(self.ema, np.asarray(blocks, np.int64),
                  np.asarray(counts, np.float64))

    # -------------------------------------------------------------- staging
    def _buffers(self, name: str, dtype) -> tuple:
        """(two host staging buffers, the device landing buffer, the
        write-back buffer) of a leaf, made at first use; pinned on a CUDA
        store, so the copies run asynchronously."""
        if name not in self._dbuf:
            rows = (max(self.stage_blocks, 1), self.block)
            tdt = _torch_dtype(dtype)
            self._hbuf[name] = [torch.empty(rows, dtype=tdt,
                                            pin_memory=self._cuda)
                                for _ in range(2)]
            self._wbuf[name] = torch.empty(rows, dtype=tdt,
                                           pin_memory=self._cuda)
            self._dbuf[name] = torch.empty(rows, dtype=tdt,
                                           device=self.device)
        return self._hbuf[name], self._dbuf[name], self._wbuf[name]

    def stage(self, blocks: np.ndarray) -> dict:
        """Start the fetch of every cold block in ``blocks``: the rows are
        gathered from the mirror into a pinned host buffer and copied to the
        device on the side stream.  Raises if the batch touches more cold
        blocks than the staging capacity (silent truncation would break
        bit-exactness), or, before any copy, when a ``stage_fail`` fault is
        armed.  -> this call's stats."""
        blocks = np.asarray(blocks, np.int64)
        cold = np.setdiff1d(blocks, self.hot_ids)          # sorted, unique
        n = int(cold.size)
        if n > self.stage_blocks:
            raise ValueError(
                f"batch touches {n} cold blocks but stage capacity is "
                f"{self.stage_blocks}; raise stage_blocks (or the tier "
                f"budget)")
        from repro_torch.resilience import faults as faults_lib
        if faults_lib.stage_fail():
            raise StageTransferError(
                "injected staging transfer failure (stage_fail fault)")
        ids = np.full(max(self.stage_blocks, 1), self.n_blocks, np.int32)
        ids[:n] = cold
        self._flip ^= 1
        done = self._read_done[self._flip]
        if done is not None:
            done.synchronize()       # the copy that last read this buffer
        if self._cuda:
            # the landing buffers' last reader is the previous install's
            # copy on the current stream
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        for name, host in self._host.items():
            hbufs, dbuf, _ = self._buffers(name, host.dtype)
            src = hbufs[self._flip]
            # every id is in range: "clip" skips numpy's buffered check
            np.take(host, cold, axis=0, out=src.numpy()[:n], mode="clip")
            if self._cuda:
                with torch.cuda.stream(self._stream):
                    dbuf[:n].copy_(src[:n], non_blocking=True)
            else:
                dbuf[:n].copy_(src[:n])
        if self._cuda:
            event = torch.cuda.Event()
            event.record(self._stream)
            self._read_done[self._flip] = self._pending_event = event
        self._pending_ids = ids
        self._pending_n = n
        nbytes = int(sum(n * self.block * h.dtype.itemsize
                         for h in self._host.values()))
        self.stats["host_fetch_bytes"] += nbytes
        self.stats["staged_blocks"] += n
        self.stats["stage_steps"] += 1
        return {"staged": n, "fetch_bytes": nbytes}

    @torch.no_grad()
    def install(self, tree: dict) -> dict:
        """Consume the pending stage: each leaf's stage region takes the
        staged rows, in place.  Must follow a :meth:`stage` call.  -> the
        same tree."""
        if self._pending_ids is None:
            raise RuntimeError("install() without stage()")
        self._register_tree(tree)
        n = self._pending_n
        if self._pending_event is not None:
            torch.cuda.current_stream(self.device).wait_event(
                self._pending_event)
        for name, leaf in tree.items():
            leaf.view(-1)[self.hot_slots: self.hot_slots + n * self.block] \
                .copy_(self._dbuf[name][:n].view(-1))
        ids = self._pending_ids
        self._staged_ids = ids[:n].astype(np.int64)
        self._stage_ids_dev = torch.from_numpy(ids).to(self.device)
        self._pending_ids = None
        self._pending_event = None
        return tree

    def writeback(self, tree: dict) -> None:
        """Persist the previous step's staged rows (post-update) to the host
        mirror.  No-op before the first stage.  Registers the moment leaves
        it has not seen (their first appearance is the fresh init)."""
        self._register_tree(tree)
        if self._staged_ids is None or not self._staged_ids.size:
            return
        n = int(self._staged_ids.size)
        lo, hi = self.hot_slots, self.hot_slots + n * self.block
        outs = {}
        for name, leaf in tree.items():
            wbuf = self._buffers(name, self._host[name].dtype)[2]
            # only the n live staged blocks cross, not the padded region
            wbuf[:n].view(-1).copy_(leaf.detach().view(-1)[lo:hi],
                                    non_blocking=self._cuda)
            outs[name] = wbuf
        if self._cuda:
            torch.cuda.current_stream(self.device).synchronize()
        nbytes = 0
        for name, wbuf in outs.items():
            self._host[name][self._staged_ids] = wbuf.numpy()[:n]
            nbytes += n * self.block * self._host[name].dtype.itemsize
        self.stats["writeback_bytes"] += nbytes

    # ------------------------------------------------------------- re-tier
    @torch.no_grad()
    def retier(self, tree: dict, max_swaps: int | None = None,
               hysteresis: float = 1.0) -> tuple[dict, dict]:
        """Promote/demote by the touch-count EMA, moving rows bit-exactly.

        Call after :meth:`writeback` and before the next :meth:`stage`.
        The whole hot slab is first written back (the mirror becomes
        authoritative for every block), then the new top-``hot_blocks`` set
        (with ``hysteresis``: a cold block must beat the weakest incumbent
        by that factor; at most ``max_swaps`` swaps) is uploaded into the
        slab in sorted-id order, in place.  -> (the same tree, counts)."""
        self._register_tree(tree)
        if not self.hot_blocks or not self.cold_blocks:
            return tree, {"promoted": 0, "demoted": 0}
        for name, leaf in tree.items():
            rows = _host_array(leaf.detach()[: self.hot_slots])
            self._host[name][self.hot_ids] = rows.reshape(
                self.hot_blocks, self.block)
        # the new hot set (ties -> lower block id, like freq's top-k)
        order = np.lexsort((np.arange(self.n_blocks), -self.ema))
        ideal = np.sort(order[: self.hot_blocks])
        incoming = np.setdiff1d(ideal, self.hot_ids)
        if hysteresis > 1.0 or max_swaps is not None:
            out_cand = np.setdiff1d(self.hot_ids, ideal)
            out_sorted = out_cand[np.argsort(self.ema[out_cand],
                                             kind="stable")]
            in_sorted = incoming[np.argsort(-self.ema[incoming],
                                            kind="stable")]
            n = min(out_sorted.size, in_sorted.size)
            if max_swaps is not None:
                n = min(n, int(max_swaps))
            keep = self.ema[in_sorted[:n]] > hysteresis * self.ema[
                out_sorted[:n]]
            in_sorted, out_sorted = in_sorted[:n][keep], out_sorted[:n][keep]
            new_hot = np.sort(np.concatenate([
                np.setdiff1d(self.hot_ids, out_sorted), in_sorted]))
            incoming = in_sorted
        else:
            new_hot = ideal
        n_swap = int(incoming.size)
        if n_swap == 0 and np.array_equal(new_hot, self.hot_ids):
            return tree, {"promoted": 0, "demoted": 0}
        self.hot_ids = new_hot.astype(np.int32)
        for name, leaf in tree.items():
            leaf.view(-1)[: self.hot_slots].copy_(torch.from_numpy(np.take(
                self._host[name], self.hot_ids, axis=0,
                mode="clip").reshape(-1)))
        self.stats["promoted"] += n_swap
        self.stats["demoted"] += n_swap
        return tree, {"promoted": n_swap, "demoted": n_swap}

    # ----------------------------------------------------------- integrity
    def sanitize_cold(self) -> int:
        """Chunked integrity scan over the host-cold tier (the numpy twin of
        ``resilience.integrity.sanitize``): zero the chunks of cold blocks
        that carry bit-rot signatures.  Hot blocks are skipped: the device
        copy is authoritative and the trainer's scan covers it.  -> the
        number of quarantined chunks."""
        from repro_torch.resilience import integrity as integ
        n_bad = 0
        cold_mask = np.ones(self.n_blocks, bool)
        cold_mask[self.hot_ids] = False
        for host in self._host.values():
            if not np.issubdtype(host.dtype, np.floating):
                continue
            clean, bad = integ.np_sanitize(host[cold_mask])
            if bad:
                host[cold_mask] = clean
                n_bad += bad
        self.stats["quarantined_cold_chunks"] += n_bad
        return n_bad
