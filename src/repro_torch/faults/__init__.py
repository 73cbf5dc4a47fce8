"""Deterministic fault injection + graceful-degradation guards (the JAX
package's ``repro.faults``).

``FaultPlan`` (:mod:`repro_torch.faults.plan`) injects seeded faults at chosen
training steps — dropped/delayed host-store fetches, corrupted halo
payload rows, NaN gradients, simulated device-memory pressure, truncated
checkpoints.  ``GuardConfig``/``TrainGuard``/``FetchGuard``
(:mod:`repro_torch.faults.guard`) are the runtime defenses each fault class
proves out.  Every injected fault and every defense action is counted, so
``injected == defended`` holds exactly (asserted by the tests and by
``chip_smoke.py``'s ``train_faults`` phase on the card).

Zero-overhead contract (same as the disabled ``repro_torch.obs.Tracer``): the
shared :data:`NULL_FAULTS` plan is a no-op — with it installed and no
guard configured, the training loop and both runtimes execute the exact
code paths they run without one.
"""
from .plan import (FAULT_KINDS, FaultPlan, FaultSpec, FetchError,
                   NULL_FAULTS)
from .guard import DefenseEvents, FetchGuard, GuardConfig, TrainGuard

__all__ = ["FAULT_KINDS", "FaultPlan", "FaultSpec", "FetchError",
           "NULL_FAULTS", "DefenseEvents", "FetchGuard", "GuardConfig",
           "TrainGuard"]
