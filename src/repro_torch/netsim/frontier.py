"""Convergence-vs-asynchrony frontier helpers.

The async suite's yardstick mirrors ``benchmarks/convergence.run_sweeps``:
the synchronous Jacobian executor sets a target objective (its iteration-
``at`` value plus a 0.1%-of-initial-gap slack — raw fp32 plateaus are a few
1e-6 apart across executors and not comparable directly), and every
(delay, drop, topology) cell reports the first iteration at which the
simulated run closes that gap.  ``tape_summary`` condenses a sampled
:class:`EventTape` into the frontier CSV's observables.
"""

from __future__ import annotations

import numpy as np

from repro_torch.netsim.events import EventTape


def gap_target(objs: np.ndarray, at: int = 100, slack: float = 1e-3) -> float:
    """Target objective: the baseline's iteration-``at`` value plus
    ``slack`` of its initial optimality gap (clamped to the horizon)."""
    objs = np.asarray(objs)
    k = min(at, objs.shape[0]) - 1
    return float(objs[k]) + slack * float(objs[0] - objs[k])


DNF = -1


def iters_to_target(objs: np.ndarray, target: float) -> int:
    """First 1-based iteration whose objective is <= target, or DNF (-1).

    A run whose objective goes non-finite (NaN/inf — heavy-tail + high-drop
    or Byzantine cells can blow the iterates up) did NOT finish: only the
    finite prefix before the first non-finite row counts.  Without the
    truncation a ``-inf`` row would register as a bogus early "hit", and a
    NaN target would silently compare False everywhere; both now return
    the explicit DNF sentinel.
    """
    objs = np.asarray(objs, np.float64)
    if not np.isfinite(target):
        return DNF
    finite = np.isfinite(objs)
    horizon = objs.shape[0] if finite.all() else int(np.argmax(~finite))
    hit = np.nonzero(objs[:horizon] <= target)[0]
    return int(hit[0]) + 1 if hit.size else DNF


def tape_summary(tape: EventTape) -> dict:
    """Observables of a sampled tape: mean/max delivered message age (in
    rounds; 1.0 = fully synchronous) and the fraction of agent-ticks that
    completed an update (1.0 = no stragglers)."""
    age = np.asarray(tape.age, np.float64)
    active = np.asarray(tape.active, np.float64)
    return {
        "mean_age": float(age.mean()) if age.size else 1.0,
        "max_age": int(age.max()) if age.size else 1,
        "active_frac": float(active.mean()) if active.size else 1.0,
    }
