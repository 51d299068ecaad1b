"""The self-healing training loop (port of ``repro.train.trainer``).

The caller supplies ``loss_fn(model, batch) -> (loss, metrics)``, the model
(an ``nn.Module``), an optimizer over its named parameters
(``repro_torch.optim``; its state, ``opt_state``, holds whatever the
optimizer keeps: Adagrad's accumulators, SGD's momenta, or Adam's step
counter with mu and nu) and a seekable ``batch_fn(step) -> batch`` of host
arrays, which the trainer moves to its device (the card unless the caller
names the CPU).  A step is ``repro_torch.resilience.guard.make_step``:

  forward -> backward -> (sparse) gradients -> [guard] -> update -> apply

With ``sparse_grads`` on (the default when ``REPRO_SPARSE_GRADS`` allows it
and the model holds a ``memory`` pool), the forward and backward run under
a sparse-gradient capture (``repro_torch.optim.sparse``): the pool's
gradient is a ``SparseGrad`` over the K touched slots, its ``.grad`` stays
``None``, and the optimizer routes it to the O(K) lazy update.
``sparse_grads=False`` keeps the dense O(m) path as the oracle.

Fault tolerance, as in the reference:
  * checkpoints through ``repro_torch.checkpoint.manager`` (atomic, async,
    the reference's format), every ``ckpt_every`` steps and on preemption;
    SIGTERM/SIGINT set the preemption flag, a second signal restores the
    default handler.  ``ckpt_delta=True`` writes incremental checkpoints
    fed by each ok step's SparseGrad indices, compacted to a full base
    every ``ckpt_compact_every`` deltas.  The durable state (``_state``)
    nests the parameter names on '.', so the pool is
    ``params/embedding/memory`` and its chunk sums, deltas and repair apply;
  * resume: ``fit`` restores the latest intact checkpoint into the live
    parameter and optimizer-state tensors (``copy_``), so the model trains
    the restored bytes;
  * the guarded step (``REPRO_GUARD_STEP``, default on): a non-finite or
    overflow-scale loss or gradient skips the step with the state
    bit-unchanged; ``max_consecutive_skips`` in a row roll back to the last
    checkpoint with bounded exponential backoff, ``max_rollbacks`` give up;
  * pool integrity: every memory leaf (and its optimizer moments) is
    scanned at each ``ckpt_every`` boundary and after every restore, bad
    chunks zeroed in place; ``rollback_on_quarantine`` restores the true
    bytes instead when a checkpoint exists;
  * fault injection (``repro_torch.resilience.faults``, ``faults=`` or
    ``REPRO_FAULTS``) drives each of these paths deterministically.

Tiering (``tier=``, a :class:`repro_torch.tier.TierController`): a pool
over its device budget trains as a compact pool (hot slab + staged cold
rows) beside a host mirror.  Before each batch the controller's
``pre_step`` writes back the last stage, re-tiers on cadence, stages and
installs this step's cold blocks, in place, and batches come through
``tier.batch_fn`` with the remap buffers.  Its planned locations feed the
delta checkpoints' dirty set.  The durable state holds the full pools
(values and moments, ``export_full``) and the tier meta (hot set, EMA); a
restore hands them to ``on_restore``, which rebuilds the mirror and the
compact pool, and a rollback drops the abandoned timeline's staged rows.
The boundary scan covers the host-cold tier too (``sanitize_cold``).

Under an installed mesh (``repro_torch.dist``) the Trainer runs on every
rank: the pool is the rank's slab and its lookups and updates take the
sharded paths.  With a 'data' axis the batch ``batch_fn`` gives is the
global one, and each rank trains on its share (``sharded_memory.
local_batch``, split when D divides it): the step differentiates the
rank's share of the global mean and reduces over 'data' (``guard.
make_step``), so every replica applies the same bits.  The guard's verdict,
a preemption flag and the boundary scan's quarantine count are agreed over
the world, so every rank skips, rolls back, saves and stops together.
Checkpoints keep the reference's format: a save gathers each pool slab
(``gather_rows``) into whole arrays that world rank 0 writes while the
others wait on a barrier, and a restore cuts this rank's slabs out of the
whole arrays (``sharding.slab_shardings``), so a checkpoint resumes on any
mesh or on one process.  An LM stored for training under the mesh
(``transformer.init(..., train=True)``) trains through the same step: its
blocks and their optimizer states are assembled whole for a save
(``sharding.assemble``) and cut by their ``lm_rules`` spec on a restore.
Only world rank 0 logs.

Throughput: steps/s from the median step time (host clock around work that
ends in a device sync), lookups/s scaled by ``lookups_per_step``; host batch
time and the tier's ``pre_step`` time are kept apart, and steps slower than
``straggler_factor`` x the median are counted in ``health``.
"""
from __future__ import annotations

import collections
import dataclasses
import signal
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint.manager import (CheckpointManager, _flatten,
                                            _unflatten)
from repro_torch.device import resolve_device
from repro_torch.dist import collectives as col
from repro_torch.dist.context import current_mesh
from repro_torch.dist.sharding import (assemble, block, is_pool_path,
                                       slab_shardings, stored_spec)
from repro_torch.optim import sparse as sparse_lib
from repro_torch.optim.optimizers import Optimizer
from repro_torch.resilience import faults as faults_lib
from repro_torch.resilience import guard as guard_lib
from repro_torch.resilience import integrity as integ_lib
from repro_torch.resilience.health import Health


def throughput_stats(step_times, lookups_per_step: int = 0,
                     tier_stats: dict | None = None) -> dict:
    """Median step wall time -> steps/s, scaled by the embedding-row lookups
    one step performs (0 when unknown).  ``tier_stats`` (a
    ``TierController.stats()`` dict, when the pool is tiered) adds the
    host-traffic view: staged cold blocks and host-fetch bytes averaged per
    staging step, the hot/cold row split and the migrations."""
    if not len(step_times):
        out = {"steps_per_sec": 0.0, "lookups_per_sec": 0.0}
    else:
        sps = 1.0 / max(float(np.median(np.asarray(step_times))), 1e-12)
        out = {"steps_per_sec": sps,
               "lookups_per_sec": sps * lookups_per_step}
    if tier_stats:
        n = max(tier_stats.get("stage_steps", 0), 1)
        out.update({
            "tier_hot_rows": tier_stats.get("hot_rows", 0),
            "tier_cold_rows": tier_stats.get("cold_rows", 0),
            "tier_staged_blocks_per_step":
                tier_stats.get("staged_blocks", 0) / n,
            "tier_host_fetch_bytes_per_step":
                tier_stats.get("host_fetch_bytes", 0) / n,
            "tier_promoted": tier_stats.get("promoted", 0),
            "tier_demoted": tier_stats.get("demoted", 0),
        })
    return out


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 200
    keep: int = 3
    log_every: int = 50
    straggler_factor: float = 3.0
    async_ckpt: bool = True
    # embedding-row lookups one step performs (B * F for field models);
    # feeds the lookups_per_sec throughput stat when set
    lookups_per_step: int = 0
    # --- durability ---
    ckpt_delta: bool = False            # incremental (delta) checkpoints
    ckpt_compact_every: int = 8         # deltas before forcing a full base
    # --- resilience ---
    guard_step: Optional[bool] = None   # None -> REPRO_GUARD_STEP (default on)
    max_abs_grad: float = guard_lib.MAX_ABS_GRAD
    max_consecutive_skips: int = 3      # skips in a row before rollback
    rollback_backoff: float = 0.05      # first rollback wait (seconds)
    rollback_backoff_max: float = 5.0   # backoff ceiling
    max_rollbacks: int = 8              # then give up (RuntimeError)
    verify_pool: bool = True            # integrity scan at ckpt boundaries
    # roll back (instead of training on zeroed rows) when the boundary scan
    # quarantines fresh corruption and a checkpoint exists
    rollback_on_quarantine: bool = False


def _quiet(_: str) -> None:
    pass


def _nested(tree):
    """A state tree in the checkpoint's layout: dict keys (parameter names)
    nested on '.', tuples kept, Python ints (step counters) as int32 arrays
    as the reference keeps them; tensors stay as they are (the manager
    copies them to the host)."""
    if isinstance(tree, dict):
        root: dict = {}
        for name, v in tree.items():
            *parents, leaf = name.split(".")
            node = root
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = _nested(v)
        return root
    if isinstance(tree, tuple):
        return tuple(_nested(v) for v in tree)
    if isinstance(tree, (int, np.integer)) and not isinstance(tree, bool):
        return np.asarray(tree, np.int32)
    return tree


def _restored(template, flat: dict, prefix: str):
    """The restored arrays ``flat`` (by checkpoint path) at the paths of
    ``template``, in its structure (dicts, tuples, NamedTuples)."""
    if isinstance(template, dict):
        return {k: _restored(v, flat, f"{prefix}/{k.replace('.', '/')}")
                for k, v in template.items()}
    if isinstance(template, tuple):
        parts = [_restored(v, flat, f"{prefix}/#{i}")
                 for i, v in enumerate(template)]
        return type(template)(*parts) if hasattr(template, "_fields") \
            else tuple(parts)
    if prefix not in flat:
        raise KeyError(f"checkpoint lacks {prefix!r}")
    return flat[prefix]


@torch.no_grad()
def _load(template, restored, prefix: str):
    """Copy ``restored`` (a tree of ``template``'s structure: arrays or
    tensors) into the live tensors of ``template`` in place; -> the
    template with its Python ints (step counters) replaced by the restored
    ones."""
    if isinstance(template, dict):
        return {k: _load(v, restored[k], f"{prefix}/{k.replace('.', '/')}")
                for k, v in template.items()}
    if isinstance(template, tuple):
        parts = [_load(v, r, f"{prefix}/#{i}")
                 for i, (v, r) in enumerate(zip(template, restored))]
        return type(template)(*parts) if hasattr(template, "_fields") \
            else tuple(parts)
    a = restored
    if isinstance(template, torch.Tensor):
        if tuple(a.shape) != tuple(template.shape):
            raise ValueError(f"{prefix}: checkpoint shape {tuple(a.shape)} "
                             f"!= live {tuple(template.shape)}")
        template.copy_(a if isinstance(a, torch.Tensor)
                       else torch.from_numpy(np.ascontiguousarray(a)))
        return template
    return int(a)


class Trainer:
    def __init__(self, cfg: TrainerConfig, loss_fn: Callable, model: nn.Module,
                 optimizer: Optimizer, batch_fn: Callable[[int], dict],
                 sparse_grads: bool | None = None,
                 on_phase: Callable[[str], None] | None = None,
                 device=None,
                 faults: faults_lib.FaultInjector | None = None,
                 tier=None):
        """``sparse_grads=None`` turns the sparse pool gradient on when the
        gate allows it and the model holds a pool.  ``on_phase(name)``, when
        given, is called as a step starts and as each of its phases ends
        (``guard.make_step``), e.g. to record CUDA events.  ``faults=None``
        builds an injector from ``REPRO_FAULTS`` when it is set; an explicit
        injector is also installed for the checkpoint manager's hooks.
        ``tier``: a :class:`repro_torch.tier.TierController` whose compact
        pool is the model's ``memory`` parameter; batches then come through
        ``tier.batch_fn`` (tiered runs update densely, as in the
        reference: pass ``sparse_grads=False``)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.model = model
        self.params = dict(model.named_parameters())
        self.optimizer = optimizer
        self.opt_state = optimizer.init(self.params)
        self.tier = tier
        self.batch_fn = tier.batch_fn if tier is not None else batch_fn
        self.step = 0
        self.mgr = (CheckpointManager(cfg.ckpt_dir, cfg.keep,
                                      delta=cfg.ckpt_delta,
                                      compact_every=cfg.ckpt_compact_every)
                    if cfg.ckpt_dir else None)
        self._resumed_step: int | None = None
        self._preempted = False
        self._step_times: collections.deque[float] = collections.deque(
            maxlen=256)
        self._batch_times: collections.deque[float] = collections.deque(
            maxlen=256)
        self._tier_times: collections.deque[float] = collections.deque(
            maxlen=256)
        self.health = Health()
        self._consecutive_skips = 0
        self.faults = faults if faults is not None else faults_lib.from_env()
        if faults is not None:
            faults_lib.install(faults)
        if sparse_grads is None:
            sparse_grads = (sparse_lib.sparse_enabled()
                            and sparse_lib.has_memory(self.params))
        self.sparse_grads = sparse_grads
        self._has_pool = sparse_lib.has_memory(self.params)
        self.guard = (cfg.guard_step if cfg.guard_step is not None
                      else guard_lib.guard_enabled())
        # delta checkpoints over a resident sparse pool: the step reports
        # its SparseGrad slot indices, the dirty-chunk feed (a tiered run
        # feeds it from pre_step's planned touches)
        self._touched_out = bool(self.mgr is not None and self.mgr.delta
                                 and sparse_grads and tier is None)
        self._step_fn = guard_lib.make_step(
            loss_fn, optimizer, sparse_grads=sparse_grads, guard=self.guard,
            max_abs_grad=cfg.max_abs_grad, report_touched=self._touched_out,
            on_phase=on_phase)

    @property
    def straggler_steps(self) -> int:
        return self.health.straggler_steps

    @straggler_steps.setter
    def straggler_steps(self, v: int):
        self.health.straggler_steps = v

    # ------------------------------------------------------------ preemption
    def install_signal_handlers(self):
        def handler(signum, frame):
            if self._preempted:
                # second signal: the graceful path is presumably hung on a
                # save -- give the user back a killable process
                signal.signal(signum, signal.SIG_DFL)
                return
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    def preempt(self):
        """Simulate a preemption notice (tests call this directly)."""
        self._preempted = True

    # ----------------------------------------------------------- checkpoints
    def _state(self) -> dict:
        """The durable state: live tensors (the manager copies them to the
        host), parameter names nested on '.', step counters as int32.  A
        tiered run persists the full pools (values and moments, numpy
        arrays from the host mirror) and the tier meta (int32 hot ids,
        float64 EMA), not the transient compact view."""
        params, opt_state = self.params, self.opt_state
        state = {}
        if self.tier is not None:
            params, opt_state = self.tier.export_full(params, opt_state)
            state["tier"] = self.tier.tier_meta()
        state.update({"params": _nested(params),
                      "opt_state": _nested(opt_state),
                      "step": np.asarray(self.step, np.int32)})
        return state

    def save(self, blocking: bool = True):
        """Checkpoint the durable state.  Under a mesh of more than one
        rank the pool slabs are gathered into whole arrays, world rank 0
        writes, and a blocking save returns on every rank once the step is
        on disk."""
        if not self.mgr:
            return
        blocking = blocking or not self.cfg.async_ckpt
        mesh = current_mesh()
        if mesh is None or mesh.world == 1:
            self.mgr.save(self.step, self._state(), blocking=blocking)
            return
        state = self._gathered_state(mesh)
        if state is not None:
            self.mgr.save(self.step, state, blocking=blocking)
        if blocking:
            self._ckpt_wait()

    def _block_paths(self, flat: dict) -> dict:
        """{checkpoint path: spec} of the durable state's ``lm_rules``
        blocks (a model stored for training under a mesh): each parameter,
        and each optimizer-state tensor under a parameter's path with that
        parameter's block shape (Adam's moments, Adafactor's ``v``; its
        whole ``v_row`` / ``v_col`` are left out)."""
        specs = {k.replace(".", "/"): (stored_spec(p), tuple(p.shape))
                 for k, p in self.params.items()
                 if stored_spec(p) is not None}
        out = {}
        if not specs:
            return out
        for path, v in flat.items():
            if not isinstance(v, torch.Tensor):
                continue
            for name, (spec, shape) in specs.items():
                if (path == f"params/{name}" or (
                        path.startswith("opt_state/")
                        and f"/{name}/" in f"{path}/")) \
                        and tuple(v.shape) == shape:
                    out[path] = spec
                    break
        return out

    def _gathered_state(self, mesh) -> dict | None:
        """The durable state with every pool slab gathered over 'model' and
        every ``lm_rules`` block assembled whole: on world rank 0 the tree
        of whole arrays a one-process Trainer's ``_state`` holds, None
        elsewhere."""
        flat = _flatten(self._state())
        blocks = self._block_paths(flat)
        out = {}
        for path, v in flat.items():
            if path in blocks:
                parts = col.all_gather(v.detach(), mesh, "world")
                v = (assemble(list(parts.cpu()), blocks[path],
                              (mesh.data, mesh.model))
                     if mesh.world_rank == 0 else None)
            elif (isinstance(v, torch.Tensor) and v.dim() >= 1
                    and is_pool_path(path)):
                v = col.gather_rows(v, mesh)
            out[path] = v
        return _unflatten(out) if mesh.world_rank == 0 else None

    def _ckpt_wait(self):
        """An in-flight async save lands (world rank 0's writer), and under
        a mesh every rank waits for it."""
        self.mgr.wait()
        mesh = current_mesh()
        if mesh is not None:
            col.barrier(mesh)

    def try_resume(self) -> bool:
        if not self.mgr:
            return False
        # an in-flight async save must land before we look for "latest"
        self._ckpt_wait()
        if self.mgr.latest_step() is None:
            return False
        mesh = current_mesh()
        slabs = slab_shardings(mesh)
        blocks = self._block_paths(_flatten(self._state()))

        def cut(path, a):
            if path in blocks:
                return block(a, mesh, blocks[path])
            return slabs(path, a)
        _, state = self.mgr.restore(shardings=cut)
        flat = _flatten(state)
        params = _restored(self.params, flat, "params")
        opt_state = _restored(self.opt_state, flat, "opt_state")
        if self.tier is not None:
            meta = {k: flat[f"tier/{k}"] for k in ("hot_ids", "ema")
                    if f"tier/{k}" in flat}
            if meta:
                # the durable cold tier: the mirror, hot set and EMA adopt
                # the checkpointed bytes; the full pools come back compact
                params, opt_state = self.tier.on_restore(params, opt_state,
                                                         meta)
            else:
                # a checkpoint of compact pools: drop the staged rows
                self.tier.on_restore()
        self.params = _load(self.params, params, "params")
        self.opt_state = _load(self.opt_state, opt_state, "opt_state")
        self.step = int(flat["step"])
        self._resumed_step = self.step
        report = self.mgr.last_restore_report
        self.health.quarantined_chunks += report.get("quarantined_chunks", 0)
        self.health.torn_writes_detected += report.get("torn_writes", 0)
        if self.cfg.verify_pool and self._has_pool:
            self._verify_pool()
        return True

    # ------------------------------------------------------------------- fit
    def fit(self, log: Callable[[str], None] = print) -> dict:
        from repro_torch.dist.sharded_memory import _batch_axes, local_batch
        mesh = current_mesh()
        many = mesh is not None and mesh.world > 1
        if mesh is not None and mesh.world_rank != 0:
            log = _quiet
        if self.try_resume():
            log(f"[trainer] resumed from step {self.step}")
        last_loss = float("nan")
        while self.step < self.cfg.total_steps:
            if many:
                # a signal reaches one process: every rank stops together
                self._preempted = bool(col.world_max(
                    torch.tensor([int(self._preempted)]), mesh)[0])
            if self._preempted:
                log(f"[trainer] preempted at step {self.step}; checkpointing")
                self.save(blocking=True)
                return self._result(last_loss, preempted=True)
            if self.faults:
                self.faults.pre_step(self, self.step)
                if self._preempted:
                    continue
            if self.tier is not None:
                # write back the last stage, re-tier on cadence, stage and
                # install this step's cold blocks -- before the batch, whose
                # remap buffers must match the installed pool
                t0 = time.perf_counter()
                _, _, tinfo = self.tier.pre_step(self.step, self.params,
                                                 self.opt_state)
                self._tier_times.append(time.perf_counter() - t0)
                if self.mgr is not None and self.mgr.delta:
                    # the planned touches are what writeback will commit
                    self.mgr.mark_dirty_slots(tinfo["touched_slots"])
            t0 = time.perf_counter()
            batch = self.batch_fn(self.step)
            t1 = time.perf_counter()
            split = mesh is not None and all(
                _batch_axes(mesh, int(v.shape[0])) for v in batch.values())
            batch = {k: torch.as_tensor(local_batch(v, mesh) if split else v
                                        ).to(self.device)
                     for k, v in batch.items()}
            fault = self.faults.grad_fault(self.step) if self.faults else 1.0
            delay = self.faults.step_delay(self.step) if self.faults else 0.0
            if delay:
                time.sleep(delay)  # inside the timed region: a straggler
            out = self._step_fn(self.model, self.params, self.opt_state,
                                batch, fault, split=split)
            self.opt_state, loss, ok, grads_ok = out[:4]
            if ok:
                last_loss = float(loss)   # waits for the update too
            elif self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            dt = time.perf_counter() - t1
            self._batch_times.append(t1 - t0)
            self._track_straggler(dt)
            if ok:
                self._consecutive_skips = 0
                if self._touched_out:
                    # this step's SparseGrad indices (a skipped step touches
                    # nothing, so only marked on ok)
                    self.mgr.mark_dirty_slots(out[4])
            else:
                self.health.skipped_steps += 1
                if not grads_ok:
                    self.health.nonfinite_grads += 1
                self._consecutive_skips += 1
                log(f"[trainer] step {self.step} non-finite; skipped "
                    f"(state untouched, {self._consecutive_skips} in a row)")
            self.step += 1
            if self.cfg.log_every and self.step % self.cfg.log_every == 0:
                tp = self.throughput()
                lk = (f" {tp['lookups_per_sec']:,.0f} lookups/s"
                      if self.cfg.lookups_per_step else "")
                hb = self.health.summary()
                log(f"[trainer] step {self.step} loss {last_loss:.4f} "
                    f"({dt * 1e3:.1f} ms, {tp['steps_per_sec']:.1f} "
                    f"steps/s{lk})" + (f" [health: {hb}]" if hb else ""))
            if self._consecutive_skips >= self.cfg.max_consecutive_skips:
                self._rollback(log)
                continue
            if self.cfg.ckpt_every and self.step % self.cfg.ckpt_every == 0:
                if self.cfg.verify_pool and self._has_pool:
                    before = self.health.quarantined_chunks
                    self._verify_pool(log)
                    if (self.cfg.rollback_on_quarantine
                            and self.health.quarantined_chunks > before
                            and self._durable_step() is not None):
                        # fresh corruption at the boundary: restoring the
                        # true bytes beats persisting zeroed rows
                        log(f"[trainer] step {self.step}: boundary scan "
                            f"quarantined fresh corruption; rolling back")
                        self._rollback(log)
                        continue
                if self.mgr:
                    self.save(blocking=False)
        if self.mgr:
            self.save(blocking=True)
            self._ckpt_wait()
        return self._result(last_loss, preempted=False)

    def _result(self, last_loss: float, preempted: bool) -> dict:
        """One dict on every exit path: the reference's keys (its exchange
        is the forced strategy or "auto"), plus ``sparse_grads`` and the
        host ``batch_sec``."""
        from repro_torch.dist import exchange as exchange_lib
        self._sync_durability()
        return {"step": self.step, "loss": last_loss, "preempted": preempted,
                "guard_enabled": bool(self.guard),
                "resumed_step": self._resumed_step,
                "exchange": exchange_lib.FORCED or "auto",
                "sparse_grads": bool(self.sparse_grads),
                **self.health.as_dict(), **self.throughput()}

    def _sync_durability(self):
        """Copy the checkpoint manager's durability gauges into the health
        record."""
        if self.mgr is None:
            return
        last = self.mgr.last_saved_step
        if last is None:
            last = self.mgr._last_step     # restored-but-not-yet-saved
        if last is not None:
            self.health.last_durable_step = int(last)
        self.health.ckpt_bytes_written = int(self.mgr.bytes_written)
        self.health.delta_chain_len = int(self.mgr.chain_len)

    # ------------------------------------------------------------ resilience
    def _verify_pool(self, log: Callable[[str], None] = print):
        """Integrity scan over every memory leaf and its optimizer moments,
        on their device; bad chunks are zeroed in place (a rotten
        accumulator chunk would poison every later update it scales)."""
        _, n_bad = integ_lib.sanitize_tree(self.params)
        _, n_bad_opt = integ_lib.sanitize_tree(self.opt_state)
        n_bad += n_bad_opt
        if self.tier is not None:
            # the host-cold tier never visits the device: its numpy twin
            n_bad += self.tier.store.sanitize_cold()
        mesh = current_mesh()
        if mesh is not None and mesh.world > 1:
            # every slab's count once (data index 0's), the same on every
            # rank, so that the ranks decide a rollback together
            n_bad = int(col.psum(torch.tensor(
                [n_bad if mesh.data_rank == 0 else 0]), mesh, "world")[0])
        if n_bad:
            self.health.quarantined_chunks += n_bad
            log(f"[trainer] pool integrity: quarantined {n_bad} corrupt "
                f"chunk(s) at step {self.step}")

    def _durable_step(self) -> int | None:
        """The newest checkpoint on disk, an in-flight async save waited
        for (the reference reads the directory without waiting, which races
        its writer when steps are fast)."""
        if not self.mgr:
            return None
        self._ckpt_wait()
        return self.mgr.latest_step()

    def _rollback(self, log: Callable[[str], None] = print):
        """K consecutive skipped steps: restore the last checkpoint and retry
        from there, with bounded exponential backoff; give up (loudly) after
        ``max_rollbacks``."""
        self._consecutive_skips = 0
        self.health.rollbacks += 1
        if self.health.rollbacks > self.cfg.max_rollbacks:
            raise RuntimeError(
                f"giving up after {self.cfg.max_rollbacks} rollbacks: "
                "training cannot make progress (persistent non-finite steps)")
        if self._durable_step() is None:
            log("[trainer] consecutive non-finite steps but no checkpoint "
                "to roll back to; continuing")
            return
        delay = min(self.cfg.rollback_backoff
                    * (2 ** (self.health.rollbacks - 1)),
                    self.cfg.rollback_backoff_max)
        time.sleep(delay)
        self.health.retries += 1
        self.try_resume()
        log(f"[trainer] rolled back to step {self.step} after "
            f"{self.cfg.max_consecutive_skips} consecutive skipped steps "
            f"(backoff {delay * 1e3:.0f} ms)")

    def throughput(self) -> dict:
        """steps/s and lookups/s (``throughput_stats``, with the tier's
        stats when tiered), the median host batch time and, when tiered,
        the median ``pre_step`` time (``tier_sec``)."""
        out = throughput_stats(
            self._step_times, self.cfg.lookups_per_step,
            tier_stats=self.tier.stats() if self.tier is not None else None)
        out["batch_sec"] = (float(np.median(self._batch_times))
                            if self._batch_times else 0.0)
        if self.tier is not None:
            out["tier_sec"] = (float(np.median(self._tier_times))
                               if self._tier_times else 0.0)
        return out

    def _track_straggler(self, dt: float):
        self._step_times.append(dt)
        if len(self._step_times) >= 16:
            med = float(np.median(self._step_times))
            if dt > self.cfg.straggler_factor * med:
                self.health.straggler_steps += 1
