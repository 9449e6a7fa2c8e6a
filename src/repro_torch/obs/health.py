"""Run-health monitors: NaN/inf, objective-divergence, and
consensus-stall detectors over the diagnostics trajectory.

``check_health`` is a pure host-side function over the (concatenated)
diag dict: ``run_checkpointed`` calls it after every segment when a
``health=`` config is passed, stamping a machine-readable ``dnf_reason``
into the checkpoint metadata and stopping the run early.
``classify_run`` turns the ``iters_to_target`` −1 sentinel of a frontier
sweep into a reason string.

Everything here works on host copies (numpy) of the diagnostics, which may
be tensors on any device; nothing imports ``repro_torch.core``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def host(x, dtype=np.float64) -> np.ndarray:
    """A numpy copy of ``x``: an array, a number, or a tensor on any
    device."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x, dtype=dtype)


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Detector thresholds.

    divergence_factor: unhealthy once objective exceeds this multiple of
        ``max(|objective[0]|, 1)``.
    stall_window: iterations over which relative objective improvement
        is measured (windows shorter than this never stall).
    stall_tol: relative improvement below this over the window counts
        as stalled, but only while consensus is still above
        ``consensus_floor`` (a converged run is flat AND agreed, which
        is success, not a stall).
    """

    divergence_factor: float = 50.0
    stall_window: int = 50
    stall_tol: float = 1e-4
    consensus_floor: float = 1e-6


_HEALTHY = {"healthy": True, "dnf_reason": "", "at_iter": -1}


def check_health(diags: dict, cfg: HealthConfig | None = None) -> dict:
    """Inspect a diag trajectory; returns
    ``{"healthy": bool, "dnf_reason": str, "at_iter": int}``.

    Reasons, in precedence order: ``"nan"`` (first non-finite
    objective), ``"objective_divergence"``, ``"consensus_stall"``.
    """
    cfg = cfg or HealthConfig()
    obj = host(diags["objective"])
    if obj.size == 0:
        return dict(_HEALTHY)
    finite = np.isfinite(obj)
    if not finite.all():
        return {
            "healthy": False,
            "dnf_reason": "nan",
            "at_iter": int(np.argmin(finite)),
        }
    ceiling = cfg.divergence_factor * max(abs(float(obj[0])), 1.0)
    over = obj > ceiling
    if over.any():
        return {
            "healthy": False,
            "dnf_reason": "objective_divergence",
            "at_iter": int(np.argmax(over)),
        }
    w = cfg.stall_window
    if w > 0 and obj.size >= w + 1:
        prev, last = float(obj[-1 - w]), float(obj[-1])
        improvement = (prev - last) / max(abs(prev), 1e-30)
        cons = host(diags.get("consensus", [np.inf]))
        if improvement < cfg.stall_tol and float(cons[-1]) > cfg.consensus_floor:
            return {
                "healthy": False,
                "dnf_reason": "consensus_stall",
                "at_iter": int(obj.size - 1),
            }
    return dict(_HEALTHY)


def classify_run(
    diags: dict, reached_target: bool, cfg: HealthConfig | None = None
) -> str:
    """DNF-reason column of a frontier sweep: ``""`` when the run hit its
    target, else the health verdict, else ``"horizon"`` (ran clean but out
    of iterations)."""
    if reached_target:
        return ""
    verdict = check_health(diags, cfg)
    return verdict["dnf_reason"] or "horizon"
