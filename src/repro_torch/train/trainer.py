"""The training loop (port of ``repro.train.trainer``, the main path).

The caller supplies ``loss_fn(model, batch) -> (loss, metrics)``, the model
(an ``nn.Module``), an optimizer over its named parameters
(``repro_torch.optim``; its state, ``opt_state``, holds whatever the
optimizer keeps: Adagrad's accumulators, SGD's momenta, or Adam's step
counter with mu and nu) and a seekable ``batch_fn(step) -> batch`` of host
arrays, which the trainer moves to its device (the card unless the caller
names the CPU).  A step is the reference's unguarded step
(``repro.resilience.guard.make_step`` with ``guard=False``; a clean guarded
step is bit-identical to it):

  forward -> backward -> (sparse) gradients -> optimizer update -> apply

With ``sparse_grads`` on (the default when ``REPRO_SPARSE_GRADS`` allows it
and the model holds a ``memory`` pool), the forward and backward run under
a sparse-gradient capture (``repro_torch.optim.sparse``): the pool's
gradient is a ``SparseGrad`` over the K touched slots, its ``.grad`` stays
``None``, and the optimizer routes it to the O(K) lazy update.
``sparse_grads=False`` keeps the dense O(m) path as the oracle.

Under an installed mesh (``repro_torch.dist``) the Trainer runs unchanged
on every rank: the pool is the rank's slab and its lookups and updates take
the sharded paths, while with a 'data' axis of 1 the dense parameters see
the same batch on every rank and need no collective.  Only rank 0 logs.

Throughput: steps/s from the median step time (host clock around work that
ends in a device sync, the loss read back), lookups/s scaled by
``lookups_per_step``; host batch time is kept apart, and steps slower than
``straggler_factor`` x the median are counted.  Checkpointing, the
non-finite guard, fault injection, pool integrity and tiering are not
ported yet.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Callable

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.optim import sparse as sparse_lib
from repro_torch.optim.optimizers import Optimizer, apply_updates


def throughput_stats(step_times, lookups_per_step: int = 0) -> dict:
    """Median step wall time -> steps/s, scaled by the embedding-row lookups
    one step performs (0 when unknown)."""
    if not len(step_times):
        return {"steps_per_sec": 0.0, "lookups_per_sec": 0.0}
    sps = 1.0 / max(float(np.median(np.asarray(step_times))), 1e-12)
    return {"steps_per_sec": sps, "lookups_per_sec": sps * lookups_per_step}


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int
    log_every: int = 50
    straggler_factor: float = 3.0
    # embedding-row lookups one step performs (B * F for field models);
    # feeds the lookups_per_sec throughput stat when set
    lookups_per_step: int = 0


def _quiet(_: str) -> None:
    pass


class Trainer:
    def __init__(self, cfg: TrainerConfig, loss_fn: Callable, model: nn.Module,
                 optimizer: Optimizer, batch_fn: Callable[[int], dict],
                 sparse_grads: bool | None = None,
                 on_phase: Callable[[str], None] | None = None,
                 device=None):
        """``sparse_grads=None`` turns the sparse pool gradient on when the
        gate allows it and the model holds a pool.  ``on_phase(name)``, when
        given, is called as a step starts ("start") and as each of its phases
        ends ("forward", "backward", "sparse_grad", "update", "apply"), e.g.
        to record CUDA events."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.loss_fn = loss_fn
        self.model = model
        self.params = dict(model.named_parameters())
        self.optimizer = optimizer
        self.opt_state = optimizer.init(self.params)
        self.batch_fn = batch_fn
        self.step = 0
        if sparse_grads is None:
            sparse_grads = (sparse_lib.sparse_enabled()
                            and sparse_lib.has_memory(self.params))
        self.sparse_grads = sparse_grads
        self.on_phase = on_phase or (lambda name: None)
        self.straggler_steps = 0
        self._step_times: collections.deque[float] = collections.deque(
            maxlen=256)
        self._batch_times: collections.deque[float] = collections.deque(
            maxlen=256)

    def train_step(self, batch: dict) -> torch.Tensor:
        """One step on ``batch``; -> the loss (a device scalar)."""
        mark = self.on_phase
        mark("start")
        for p in self.params.values():
            p.grad = None
        scope = (sparse_lib.capture() if self.sparse_grads
                 else contextlib.nullcontext())
        with scope as cap:
            loss, _ = self.loss_fn(self.model, batch)
            mark("forward")
            loss.backward()
            mark("backward")
        grads = {k: p.grad for k, p in self.params.items()
                 if p.grad is not None}
        if cap is not None:
            grads.update(cap.grads(self.params))
        mark("sparse_grad")
        updates, self.opt_state = self.optimizer.update(
            grads, self.opt_state, self.params)
        mark("update")
        apply_updates(self.params, updates)
        mark("apply")
        return loss.detach()

    def fit(self, log: Callable[[str], None] = print) -> dict:
        from repro_torch.dist.context import current_mesh
        mesh = current_mesh()
        if mesh is not None and mesh.rank != 0:
            log = _quiet
        last_loss = float("nan")
        while self.step < self.cfg.total_steps:
            t0 = time.perf_counter()
            batch = self.batch_fn(self.step)
            t1 = time.perf_counter()
            batch = {k: torch.as_tensor(v).to(self.device)
                     for k, v in batch.items()}
            last_loss = float(self.train_step(batch))   # waits for the card
            dt = time.perf_counter() - t1
            self._batch_times.append(t1 - t0)
            self._track_straggler(dt)
            self.step += 1
            if self.cfg.log_every and self.step % self.cfg.log_every == 0:
                tp = self.throughput()
                lk = (f" {tp['lookups_per_sec']:,.0f} lookups/s"
                      if self.cfg.lookups_per_step else "")
                log(f"[trainer] step {self.step} loss {last_loss:.4f} "
                    f"({dt * 1e3:.1f} ms, {tp['steps_per_sec']:.1f} "
                    f"steps/s{lk})")
        return {"step": self.step, "loss": last_loss,
                "sparse_grads": bool(self.sparse_grads),
                "straggler_steps": self.straggler_steps,
                **self.throughput()}

    def throughput(self) -> dict:
        out = throughput_stats(self._step_times, self.cfg.lookups_per_step)
        out["batch_sec"] = (float(np.median(self._batch_times))
                            if self._batch_times else 0.0)
        return out

    def _track_straggler(self, dt: float):
        self._step_times.append(dt)
        if len(self._step_times) >= 16:
            med = float(np.median(self._step_times))
            if dt > self.cfg.straggler_factor * med:
                self.straggler_steps += 1
