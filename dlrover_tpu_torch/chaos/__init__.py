"""Deterministic fault injection for failure drills — the port's copy of
the injector and the site registry of ``dlrover_tpu/chaos/``.

A drill scripts a :class:`FaultPlan` (seed + events) and exports it
through ``DLROVER_TPU_CHAOS``; every instrumented call site consults
``fault_hit``. With the variable unset, ``fault_hit`` is a single
lookup returning None. ``ChaosStorage`` comes with ROADMAP queue 1,
item 5.
"""

from dlrover_tpu_torch.chaos.injector import (
    CHAOS_ENV,
    CHAOS_LOG_ENV,
    FaultEvent,
    FaultInjector,
    FaultPlan,
    fault_hit,
)

__all__ = [
    "CHAOS_ENV",
    "CHAOS_LOG_ENV",
    "FaultEvent",
    "FaultInjector",
    "FaultPlan",
    "fault_hit",
]
