"""Exchange-strategy validation and the demotion ladder (port of
``repro.resilience.exchange_guard``).

A chunked exchange strategy (ring, all_to_all) that silently drops or
corrupts a chunk poisons every lookup it assembles.  :class:`ExchangeGuard`
runs a *probe* -- a small representative sharded lookup the caller
supplies -- under each candidate strategy and validates what it assembled:

* its shape against the psum oracle's,
* finiteness (a corrupted chunk shows up as NaN or inf),
* optionally bitwise equality with the psum oracle (every strategy is
  specified bit-identical, so any difference is a fault: this is what
  catches a *dropped* chunk, whose zeros look finite).

A strategy that fails is retried once (a transient fault, counted in
``health.retries``); a second failure demotes it process-wide through
``repro_torch.dist.exchange.demote`` (all_to_all -> ring -> psum), so every
later ``resolve_exchange`` / ``resolve_update_exchange`` avoids it.  psum,
the oracle, is terminal and never demoted.

Each strategy is probed once.  The reference probes a chunked strategy twice,
through its fused-chunked Pallas engine and its split path, because its
dispatch may run either; the port has one lookup path per strategy, the
kernels' (on the CPU their plain versions in the same places), so one probe
covers everything the strategy can run.  Under an installed mesh of more
than one rank every verdict is agreed over the world (a failure on any rank
fails the probe on all), so the ranks demote together.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.dist import exchange as exl
from repro_torch.resilience.health import Health

def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _agreed(reason: str | None) -> str | None:
    """``reason``, or a failure on another rank of the installed mesh."""
    from repro_torch.dist import collectives as col
    from repro_torch.dist.context import current_mesh
    mesh = current_mesh()
    if mesh is None or mesh.world == 1:
        return reason
    flag = torch.tensor([reason is not None], dtype=torch.int32)
    if int(col.world_max(flag, mesh)[0]) and reason is None:
        return "the probe failed on another rank"
    return reason


class ExchangeGuard:
    """Validate the chunked strategies against the psum oracle; demote
    failures.

    ``probe_fn(name)`` runs one representative sharded lookup pinned to
    strategy ``name`` (for instance under ``exchange.FORCED = name``) and
    returns what it assembled (a tensor on any device, or an array).
    ``use_oracle=False`` checks shape and finiteness only."""

    def __init__(self, probe_fn: Callable[[str], object],
                 health: Optional[Health] = None,
                 log: Callable[[str], None] = print,
                 use_oracle: bool = True):
        self.probe_fn = probe_fn
        self.health = health if health is not None else Health()
        self.log = log
        self.use_oracle = use_oracle

    def _check(self, name: str, oracle) -> str | None:
        """-> the failure reason, or None when the strategy validates."""
        try:
            out = _host(self.probe_fn(name))
        except Exception as e:  # noqa: BLE001 -- any probe crash is a failure
            return _agreed(f"probe raised {type(e).__name__}: {e}")
        reason = None
        if oracle is not None and out.shape != oracle.shape:
            reason = f"shape {out.shape} != oracle {oracle.shape}"
        elif (np.issubdtype(out.dtype, np.floating)
              and not np.isfinite(out).all()):
            reason = "non-finite values in assembled lookup"
        elif oracle is not None and out.tobytes() != oracle.tobytes():
            reason = "not bit-identical to the psum oracle"
        return _agreed(reason)

    def validate(self) -> str:
        """Walk ``exchange.FALLBACK`` from all_to_all; -> the first strategy
        that validates ('psum' in the worst case: the oracle validates by
        definition)."""
        oracle = _host(self.probe_fn("psum")) if self.use_oracle else None
        name = "all_to_all"
        while name != "psum":
            if name in exl.DEMOTED:
                name = exl.FALLBACK[name]
                continue
            reason = self._check(name, oracle)
            if reason is None:
                return name
            # one retry: a transient glitch should not cost a strategy
            self.health.retries += 1
            retry_reason = self._check(name, oracle)
            if retry_reason is None:
                self.log(f"[exchange-guard] {name} recovered on retry "
                         f"(first failure: {reason})")
                return name
            exl.demote(name, retry_reason)
            self.health.exchange_demotions += 1
            self.log(f"[exchange-guard] demoted {name}: {retry_reason} "
                     f"(retry after: {reason})")
            name = exl.FALLBACK[name]
        return "psum"
