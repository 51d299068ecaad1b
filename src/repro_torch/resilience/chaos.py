"""Chaos soak harness: runs under a seeded randomized fault schedule (port
of ``repro.resilience.chaos``).

The soak composes the self-healing paths the way production meets them --
preemptions, torn checkpoint writes, pool bit-rot and NaN gradients at
seeded-random steps -- and asserts the durability contract:

  * the run completes (restart-on-preempt until done, bounded);
  * every restore comes from an intact (base, deltas...) chain, so no
    incarnation loses more than ``ckpt_every`` steps of work;
  * with every fault transient, the final parameters and every optimizer
    moment are **bit-identical** to a never-faulted run.

``make_trainer(injector)`` must build a *fresh* Trainer wired to the given
injector and a checkpoint directory shared across incarnations; the
injector is shared, so a fault consumed before a crash stays consumed.
"""
from __future__ import annotations

import numpy as np

from repro_torch.resilience import faults as faults_lib

# the soak's default fault mix -- every kind is transient (fires once), so a
# schedule drawn from these must heal to bit-identity
SOAK_KINDS = ("preempt", "torn_ckpt", "rot_row", "stage_fail", "nan_grad")


def make_schedule(total_steps: int, seed: int = 0,
                  kinds=SOAK_KINDS, n_faults: int | None = None,
                  min_step: int = 1) -> str:
    """Draw a seeded ``REPRO_FAULTS``-grammar schedule: ``n_faults``
    (default ~1 per 40 steps) distinct steps in ``[min_step, total_steps)``,
    each given a random kind.  The reference's draw, string for string."""
    rng = np.random.default_rng(seed)
    if n_faults is None:
        n_faults = max(total_steps // 40, 1)
    lo = max(int(min_step), 0)
    hi = max(int(total_steps), lo + 2)
    steps = rng.choice(np.arange(lo, hi), size=min(int(n_faults), hi - lo),
                       replace=False)
    picks = rng.choice(np.asarray(kinds, object), size=steps.size)
    toks = [f"{k}@{int(s)}"
            for s, k in sorted(zip(steps.tolist(), picks.tolist()))]
    return ",".join(toks)


def run_chaos(trainer_factory, spec: str, seed: int = 0,
              max_restarts: int = 16, log=lambda s: None) -> dict:
    """Drive ``trainer_factory(injector)`` to completion under ``spec``:
    each call is one process incarnation; a preempted exit restarts, up to
    ``max_restarts``.  -> the last incarnation's ``fit`` result, with
    ``chaos_restarts`` and ``chaos_max_lost_steps`` (the largest step
    regression any restart observed)."""
    inj = faults_lib.FaultInjector(spec, seed)
    restarts = 0
    max_lost = 0
    prev_exit_step: int | None = None
    while True:
        tr = trainer_factory(inj)
        faults_lib.install(inj)
        try:
            res = tr.fit(log=log)
        finally:
            faults_lib.install(None)
        resumed = res.get("resumed_step")
        if prev_exit_step is not None:
            max_lost = max(max_lost,
                           prev_exit_step - (resumed if resumed is not None
                                             else 0))
        if not res.get("preempted"):
            break
        prev_exit_step = res["step"]
        restarts += 1
        if restarts > max_restarts:
            raise RuntimeError(
                f"chaos soak did not complete within {max_restarts} restarts "
                f"(stuck at step {res['step']})")
        log(f"[chaos] preempted at step {res['step']}; restarting "
            f"({restarts}/{max_restarts})")
    res["chaos_restarts"] = restarts
    res["chaos_max_lost_steps"] = int(max_lost)
    return res


def durable_state(trainer) -> dict:
    """Flat ``{path: np.ndarray}`` of the trainer's durable state --
    parameters and every optimizer moment, as a checkpoint persists them
    (full pools for a tiered run), copied to the host -- without the step
    counter and the tier meta: the bit-identity comparison surface of the
    soak."""
    from repro_torch.checkpoint.manager import _flatten, _host
    flat = _flatten(trainer._state())
    return {k: _host(v) for k, v in flat.items()
            if k != "step" and not k.startswith("tier")}


def states_bit_identical(a: dict, b: dict) -> bool:
    if set(a) != set(b):
        return False
    return all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
               and np.array_equal(np.ascontiguousarray(a[k]).view(np.uint8),
                                  np.ascontiguousarray(b[k]).view(np.uint8))
               for k in a)
