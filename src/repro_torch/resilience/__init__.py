"""Self-healing training (port of ``repro.resilience``): fault injection,
the non-finite step guard, pool integrity, health counters and the chaos
soak.

    faults     the injector (``REPRO_FAULTS=nan_grad@17,rot_row@40``)
    guard      the guarded train step (``make_step``): a poisoned step is
               skipped, state bit-untouched
    integrity  chunked pool checksums, corruption scan, quarantine
    health     the Health record ``Trainer.fit`` reports
    chaos      the seeded chaos soak harness
    exchange_guard  probes the chunked exchange strategies against the psum
               oracle and demotes a faulty one (``FaultyExchange`` in
               faults injects the chunk faults it finds)
"""
from repro_torch.resilience.chaos import (durable_state, make_schedule,  # noqa: F401
                                          run_chaos, states_bit_identical)
from repro_torch.resilience.exchange_guard import ExchangeGuard  # noqa: F401
from repro_torch.resilience.faults import (FaultInjector, active_injector,  # noqa: F401
                                           from_env, install, parse_faults)
from repro_torch.resilience.guard import (all_finite, guard_enabled,  # noqa: F401
                                          make_step)
from repro_torch.resilience.health import Health  # noqa: F401
