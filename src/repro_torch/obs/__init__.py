"""Observability layer: span tracing, health monitors, comm counters,
and run reports (see ``repro_torch.obs.trace`` for the design contract).

Free of ``repro_torch.core`` imports so the checkpoint runtime can use it
without import cycles.
"""

from repro_torch.obs.counters import modeled_floats_per_iter
from repro_torch.obs.health import HealthConfig, check_health, classify_run
from repro_torch.obs.trace import (
    Tracer,
    block_until_ready,
    current,
    span,
    timed,
    use,
    validate_trace,
)
from repro_torch.obs import report

__all__ = [
    "HealthConfig",
    "Tracer",
    "block_until_ready",
    "check_health",
    "classify_run",
    "current",
    "modeled_floats_per_iter",
    "report",
    "span",
    "timed",
    "use",
    "validate_trace",
]
