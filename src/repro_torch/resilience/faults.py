"""Deterministic fault injection for the training stack (port of
``repro.resilience.faults``).

A :class:`FaultInjector` is built from a compact spec -- ``kind@step``
tokens, comma-separated, each optionally carrying a ``:arg`` --

    REPRO_FAULTS="nan_grad@17,rot_row@40:8,slow_rank@55:0.5,drop_chunk@60"

and is consulted by the trainer (gradient faults, slow ranks, bit-rot,
preemption), the checkpoint manager (host read failures, torn writes) and
the sharded drivers (exchange chunk drop and corruption).
Injection is seeded and replayable: the same spec and seed give the same
corruption bits as the reference's injector.

Fault kinds
-----------
``nan_grad`` / ``inf_grad`` / ``huge_grad``
    Scale that step's gradients by NaN / +inf / 1e30 (``:arg`` overrides the
    multiplier).
``rot_row``
    Flip bit 30 (the exponent's top bit) of ``:arg`` (default 8) seeded
    elements of every memory-pool leaf before the step runs, in place on
    the leaf's device -- silent storage bit-rot.
``slow_rank``
    Sleep ``:arg`` seconds (default 0.25) inside the timed step.
``preempt``
    Raise the trainer's preemption flag.
``read_fail``
    Fail the next checkpoint host read (consumed once).
``torn_ckpt``
    Truncate the next checkpoint's array payload after it lands (consumed
    once); ``:arg`` fixes the surviving fraction, else a seeded draw in
    [0.2, 0.8].
``stage_fail``
    Fail the next staging transfer of the tiered store (consumed once,
    before any copy: ``repro_torch.tier.store.TieredStore.stage`` raises
    ``StageTransferError``); the tier controller retries the stage, so
    training never sees it.
``drop_chunk`` / ``corrupt_chunk``
    Zero / NaN-poison the first batch chunk (the first ``n / P`` rows, the
    chunk ``exchange.chunk_for_rank`` gives 'model' rank 0) of every lookup
    a chunked exchange strategy assembles, persistently from ``step`` on:
    a bad link stays bad until the strategy is demoted
    (``repro_torch.resilience.exchange_guard``).  ``wrap_exchange`` hooks
    them into the sharded drivers; the psum oracle is exempt.

Gradient, rot, slow, preempt, read, torn and stage faults fire once; chunk
faults persist.
``reset()`` re-arms everything for tests.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.dist import exchange as exl
from repro_torch.resilience.integrity import is_memory

GRAD_KINDS = {
    "nan_grad": float("nan"),
    "inf_grad": float("inf"),
    "huge_grad": 1e30,
}
KINDS = tuple(GRAD_KINDS) + ("rot_row", "slow_rank", "preempt", "read_fail",
                             "drop_chunk", "corrupt_chunk", "torn_ckpt",
                             "stage_fail")


@dataclasses.dataclass
class Fault:
    kind: str
    step: int
    arg: float | None = None
    fired: bool = False


def parse_faults(spec: str) -> list[Fault]:
    """``"kind@step[:arg],..."`` -> sorted fault list.  Raises ValueError on
    unknown kinds or malformed tokens (a typo'd spec that injected nothing
    would void a whole resilience drill)."""
    faults = []
    for tok in (spec or "").split(","):
        tok = tok.strip()
        if not tok:
            continue
        kind, at, rest = tok.partition("@")
        if not at or not rest:
            raise ValueError(f"malformed fault {tok!r} (want kind@step[:arg])")
        if kind not in KINDS:
            raise ValueError(f"unknown fault kind {kind!r} "
                             f"(known: {', '.join(KINDS)})")
        step_s, colon, arg_s = rest.partition(":")
        try:
            step = int(step_s)
            arg = float(arg_s) if colon else None
        except ValueError:
            raise ValueError(f"malformed fault {tok!r} (want kind@step[:arg])")
        faults.append(Fault(kind, step, arg))
    faults.sort(key=lambda f: f.step)
    return faults


def rot_indices(seed: int, step: int, size: int, n: int) -> np.ndarray:
    """The elements ``rot_row`` flips in a leaf of ``size`` elements (the
    reference's draw)."""
    rng = np.random.default_rng((seed << 20) ^ (step + 1))
    return rng.integers(0, size, size=min(n, size))


class FaultInjector:
    """Seeded, deterministic fault source shared by the whole stack."""

    def __init__(self, spec: str = "", seed: int = 0):
        self.spec = spec
        self.seed = seed
        self.faults = parse_faults(spec)
        self.now = 0  # last step the trainer told us about

    def __bool__(self):
        return bool(self.faults)

    def reset(self):
        for f in self.faults:
            f.fired = False
        self.now = 0

    # ------------------------------------------------------- gradient faults
    def grad_fault(self, step: int) -> float:
        """Multiplier for this step's gradients (1.0 = clean).  Fires at most
        one gradient fault per step, once each."""
        self.now = max(self.now, step)
        for f in self.faults:
            if not f.fired and f.step == step and f.kind in GRAD_KINDS:
                f.fired = True
                return GRAD_KINDS[f.kind] if f.arg is None else f.arg
        return 1.0

    # ----------------------------------------------------- trainer-side hooks
    def step_delay(self, step: int) -> float:
        """Seconds to stall inside the timed region (straggler injection)."""
        self.now = max(self.now, step)
        for f in self.faults:
            if not f.fired and f.step == step and f.kind == "slow_rank":
                f.fired = True
                return f.arg if f.arg is not None else 0.25
        return 0.0

    def pre_step(self, trainer, step: int):
        """Host-side faults applied before the step launches: bit-rot the
        memory pool, or raise the preemption flag."""
        self.now = max(self.now, step)
        for f in self.faults:
            if f.fired or f.step != step:
                continue
            if f.kind == "rot_row":
                f.fired = True
                n = int(f.arg) if f.arg is not None else 8
                trainer.params = self.rot_memory(trainer.params, step, n)
            elif f.kind == "preempt":
                f.fired = True
                trainer.preempt()

    @torch.no_grad()
    def rot_memory(self, params: dict, step: int, n: int = 8) -> dict:
        """XOR bit 30 into ``n`` seeded elements of every float32 memory
        leaf of ``params`` (by name), in place through an int32 view: the
        values become huge (or NaN), as real bit-rot would.  -> params."""
        for name, x in params.items():
            if not is_memory(name) or x.dtype != torch.float32:
                continue
            flat = x.detach().view(-1).view(torch.int32)
            idx = torch.from_numpy(rot_indices(self.seed, step, flat.numel(),
                                               n)).to(flat.device)
            flat[idx] = flat[idx] ^ (1 << 30)
        return params

    # -------------------------------------------------------------- io faults
    def io_fault(self) -> bool:
        """True -> the caller should fail this host read (consumed once)."""
        for f in self.faults:
            if not f.fired and f.kind == "read_fail" and self.now >= f.step:
                f.fired = True
                return True
        return False

    def torn_ckpt_fault(self) -> float | None:
        """Surviving fraction for the next checkpoint array payload, or None
        (consumed once)."""
        for f in self.faults:
            if not f.fired and f.kind == "torn_ckpt" and self.now >= f.step:
                f.fired = True
                if f.arg is not None:
                    return min(max(float(f.arg), 0.0), 0.99)
                rng = np.random.default_rng((self.seed << 20) ^ (f.step + 3))
                return float(rng.uniform(0.2, 0.8))
        return None

    def stage_fail_fault(self) -> bool:
        """True -> a tiered store should fail this staging transfer
        (consumed once)."""
        for f in self.faults:
            if not f.fired and f.kind == "stage_fail" and self.now >= f.step:
                f.fired = True
                return True
        return False


    def exchange_fault(self) -> str | None:
        """'drop' | 'corrupt' | None.  Persistent once armed: a flaky link
        stays flaky; healing is the guard demoting away from it."""
        for f in self.faults:
            if f.kind in ("drop_chunk", "corrupt_chunk") and self.now >= f.step:
                return "drop" if f.kind == "drop_chunk" else "corrupt"
        return None


# --------------------------------------------------------- process-global
#
# One injector per process, as in the reference.  The trainer owns its own
# injector; install() also exposes it to the checkpoint manager and the
# sharded drivers, which have no trainer reference.

ACTIVE: FaultInjector | None = None


def install(inj: FaultInjector | None):
    global ACTIVE
    ACTIVE = inj


def active_injector() -> FaultInjector | None:
    return ACTIVE


def from_env() -> FaultInjector | None:
    """Build (and install) an injector from ``REPRO_FAULTS`` /
    ``REPRO_FAULTS_SEED``; None when the env is clean."""
    spec = os.environ.get("REPRO_FAULTS", "").strip()
    if not spec:
        return None
    inj = FaultInjector(spec, int(os.environ.get("REPRO_FAULTS_SEED", "0")))
    install(inj)
    return inj


def io_fault() -> bool:
    """Hook the checkpoint manager consults on every host read."""
    return ACTIVE is not None and ACTIVE.io_fault()


def torn_ckpt() -> float | None:
    """Hook the checkpoint manager consults after each write: surviving
    fraction of the array payload, or None (intact)."""
    return ACTIVE.torn_ckpt_fault() if ACTIVE is not None else None


def stage_fail() -> bool:
    """Hook a tiered store consults on each staging transfer."""
    return ACTIVE is not None and ACTIVE.stage_fail_fault()


# ------------------------------------------------------- exchange wrapping

class FaultyExchange(exl.Exchange):
    """Delegates to a real strategy but mangles the first batch chunk of
    every lookup it assembles: the injected form of a flaky inter-rank
    link.  Keeps the base strategy's ``name``, so the drivers' dispatch and
    the guard's demotion see the strategy itself."""

    def __init__(self, base: exl.Exchange, injector: FaultInjector):
        self.base = base
        self.injector = injector
        self.name = base.name

    def eligible(self, n_flat, n_model):
        return self.base.eligible(n_flat, n_model)

    def _mangle(self, out: torch.Tensor, n_model: int) -> torch.Tensor:
        kind = self.injector.exchange_fault()
        if kind is None or out.shape[0] == 0:
            return out
        c = max(out.shape[0] // max(n_model, 1), 1)
        out = out.clone()
        if kind == "drop":
            out[:c] = 0
        elif out.is_floating_point():
            out[:c] = float("nan")
        else:
            out[:c] = torch.iinfo(out.dtype).max
        return out

    def lookup(self, mem_l, gids, d, mesh, engine):
        out, loc = self.base.lookup(mem_l, gids, d, mesh, engine)
        return self._mangle(out, mesh.model), loc

    def set_lookup(self, shard, idx, mesh):
        return self.base.set_lookup(shard, idx, mesh)

    def set_lookup_many(self, shards, idx, mesh):
        return self.base.set_lookup_many(shards, idx, mesh)

    def partial_sum_lookup(self, local_fn, idx, mesh):
        return self.base.partial_sum_lookup(local_fn, idx, mesh)

    def reduce_update(self, u, mesh):
        return self.base.reduce_update(u, mesh)


def wrap_exchange(ex: exl.Exchange) -> exl.Exchange:
    """The drivers' hook (``sharded_memory._resolve``): ``ex`` wrapped when
    the installed injector has an armed chunk fault.  The psum oracle is
    exempt: it is the strategy the guard demotes to."""
    if (ACTIVE is not None and ACTIVE.exchange_fault() is not None
            and ex.name != "psum"):
        return FaultyExchange(ex, ACTIVE)
    return ex
