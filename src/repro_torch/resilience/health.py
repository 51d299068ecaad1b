"""Health counters for the self-healing training loop (port of
``repro.resilience.health``).

One mutable :class:`Health` record per Trainer aggregates every resilience
event the run survived: steps skipped by the non-finite guard, gradient
non-finites observed, straggler steps, retries, checkpoint rollbacks, pool
chunks quarantined by the integrity scan, exchange-strategy demotions
(``repro_torch.resilience.exchange_guard``), and torn checkpoint writes the
restore ladder had to route around.  ``fit()`` merges the record
into its result dict.

Three durability *gauges* -- ``last_durable_step``, ``ckpt_bytes_written``,
``delta_chain_len`` -- describe the checkpoint state rather than a fault, so
they are excluded from :meth:`Health.any_faults` and :meth:`Health.summary`.
"""
from __future__ import annotations

import dataclasses

# durability gauges: state descriptors, not fault events
_GAUGES = ("last_durable_step", "ckpt_bytes_written", "delta_chain_len")


@dataclasses.dataclass
class Health:
    skipped_steps: int = 0        # steps dropped by the non-finite guard
    nonfinite_grads: int = 0      # skipped steps where the gradient was bad
    straggler_steps: int = 0      # steps slower than straggler_factor x median
    retries: int = 0              # retried operations (rollback waits,
                                  # exchange revalidation attempts)
    rollbacks: int = 0            # restore-from-checkpoint after K skips
    quarantined_chunks: int = 0   # pool chunks zeroed by the integrity scan
    exchange_demotions: int = 0   # strategies demoted down the fallback chain
    torn_writes_detected: int = 0  # torn/corrupt checkpoint payloads the
                                   # restore path detected and routed around
    # --- durability gauges (excluded from any_faults / summary) ---
    last_durable_step: int = -1   # newest step with an on-disk checkpoint
    ckpt_bytes_written: int = 0   # cumulative checkpoint array bytes written
    delta_chain_len: int = 0      # deltas since the last full base checkpoint

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def any_faults(self) -> bool:
        return any(v for k, v in self.as_dict().items() if k not in _GAUGES)

    def summary(self) -> str:
        """Compact ``k=v`` string of the non-zero counters ('' when clean)."""
        items = [(k, v) for k, v in self.as_dict().items()
                 if v and k not in _GAUGES]
        return " ".join(f"{k}={v}" for k, v in items)
