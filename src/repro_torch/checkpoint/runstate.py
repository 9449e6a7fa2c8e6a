"""Checkpointable consensus runs: RunState save/restore + segment driver.

The bridge between ``repro_torch.core.engine``'s segmented ``Runner`` and
the flat-npz checkpoint store: a run checkpoint at iteration ``k`` is ONE
``step_<k:08d>`` directory holding the full serialized ``RunState`` AND the
diagnostics trajectory of iterations ``[0, k)``, so a resumed run returns
the complete trajectory, bit for bit what the uninterrupted run on the
same device gives (the runner's segment property makes the state side
free; storing the diagnostics prefix makes the trajectory side free).

This module imports nothing of ``repro_torch.core``: it duck-types on the
NamedTuple protocol of ``RunState`` (``U``, ``A``, ``lam``, ``k`` and the
ring buffers, ``None`` where an executor has none).

Layout per checkpoint, the reference's (``repro.checkpoint.runstate``):

    <dir>/step_<k>/arrays.npz   ``diags/<key>`` + ``state/<field>`` leaves
                                (sorted, as JAX flattens a dict); ``k`` a
                                0-d int32 array
    <dir>/step_<k>/meta.json    step, key order, dtype strings, and the
                                ``executor`` / ``iters`` audit metadata

``REPRO_CHECKPOINT_EXIT_AFTER_SAVE=<k>`` (env) hard-exits the process via
``os._exit(0)`` right after a save at step >= k: the crash-injection hook
that kills a run at a real checkpoint boundary.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpoint import (
    latest_step,
    load_checkpoint,
    read_meta,
    save_checkpoint,
)
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.health import HealthConfig, check_health

_EXIT_ENV = "REPRO_CHECKPOINT_EXIT_AFTER_SAVE"


def save_run_checkpoint(directory: str | Path, state: Any, diags: dict,
                        metadata: Optional[dict] = None) -> Path:
    """Save a mid-run snapshot: the RunState + the full diags prefix.

    The step number IS ``int(state.k)``, so ``latest_step`` always names
    the furthest-advanced snapshot.
    """
    step = int(state.k)
    fields = state._asdict()
    fields["k"] = np.asarray(step, np.int32)
    return save_checkpoint(directory, step,
                           {"state": fields, "diags": dict(diags)},
                           metadata=metadata)


def load_run_checkpoint(directory: str | Path, template_state: Any, *,
                        step: Optional[int] = None):
    """Restore ``(state, diags, meta)`` from a run checkpoint.

    ``template_state`` (e.g. ``runner.init_state()``) supplies the
    RunState class, field names, expected leaf shapes and the device: each
    state leaf lands on its template leaf's device, ``k`` comes back as an
    int, and the diagnostics prefix lands on the device of ``U``, keyed
    like the executor's diags dict.
    """
    raw, meta = load_checkpoint(directory, None, step=step)
    fields = {}
    for name, tmpl in template_state._asdict().items():
        if tmpl is None:
            fields[name] = None
            continue
        key = f"state/{name}"
        if key not in raw:
            raise ValueError(
                f"checkpoint at {directory} lacks state leaf {name!r} — "
                f"was it written by a different executor?"
            )
        arr = raw[key]
        shape = tuple(getattr(tmpl, "shape", ()))
        if tuple(arr.shape) != shape:
            raise ValueError(
                f"checkpoint state leaf {name}: shape {tuple(arr.shape)} != "
                f"template {shape}"
            )
        fields[name] = (arr.to(tmpl.device) if isinstance(tmpl, torch.Tensor)
                        else int(arr))
    state = type(template_state)(**fields)
    device = template_state.U.device
    diags = {name.split("/", 1)[1]: arr.to(device)
             for name, arr in raw.items() if name.startswith("diags/")}
    return state, diags, meta


def _concat_diags(parts: list) -> dict:
    if not parts:
        return {}
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def run_checkpointed(runner, *, checkpoint_dir: str | Path,
                     checkpoint_every: int = 0, resume: bool = False,
                     metadata: Optional[dict] = None,
                     health: "HealthConfig | bool | None" = None):
    """Drive ``runner`` to ``cfg.iters`` with periodic checkpoints.

    ``checkpoint_every=k`` saves after every k-iteration segment (0 = one
    save at the end); ``resume=True`` restarts from the latest snapshot
    under ``checkpoint_dir`` when one exists (and starts fresh otherwise,
    so first runs and resumed runs share one call site).  Returns
    ``(state, diags)`` where ``diags`` is the FULL trajectory over
    ``[0, cfg.iters)``, bit for bit the uninterrupted ``runner.run()``.

    ``health=`` arms the post-segment run-health monitor
    (``repro_torch.obs.health.check_health``; ``True`` uses the default
    :class:`HealthConfig`): an unhealthy trajectory (NaN/inf objective,
    objective divergence, consensus stall) stops the run EARLY at the
    segment boundary; the final snapshot carries ``dnf_reason`` /
    ``dnf_at_iter`` in its metadata, and the returned diagnostics cover
    only the iterations actually run.  A healthy monitored run is bit for
    bit the unmonitored one.
    """
    total = int(runner.cfg.iters)
    every = int(checkpoint_every) if checkpoint_every else total
    if every <= 0:
        raise ValueError(
            f"checkpoint_every must be >= 0, got {checkpoint_every}"
        )
    hcfg = None
    if health is not None and health is not False:
        hcfg = HealthConfig() if health is True else health
    meta = dict(metadata or {})
    meta.setdefault("executor", runner.executor)
    meta.setdefault("iters", total)

    state, parts = None, []
    if resume and latest_step(checkpoint_dir) is not None:
        # validate executor compatibility BEFORE rebuilding state, so a
        # mismatch surfaces as this error and not a missing-leaf one
        saved_exec = read_meta(checkpoint_dir).get(
            "metadata", {}
        ).get("executor")
        if saved_exec is not None and saved_exec != runner.executor:
            raise ValueError(
                f"checkpoint under {checkpoint_dir} was written by "
                f"executor {saved_exec!r}, cannot resume with "
                f"{runner.executor!r}"
            )
        with obs_trace.span("restore", dir=str(checkpoint_dir)):
            state, prev, _ = load_run_checkpoint(checkpoint_dir,
                                                 runner.init_state())
        if prev:
            parts.append(prev)
    if state is None:
        state = runner.init_state()

    exit_after = os.environ.get(_EXIT_ENV)
    done = int(state.k)
    while done < total:
        state, diags = runner.run_segment(state, min(every, total - done))
        parts.append(diags)
        done = int(state.k)
        verdict = None
        if hcfg is not None:
            verdict = check_health(_concat_diags(parts), hcfg)
            if not verdict["healthy"]:
                # stamp BEFORE the save so the final snapshot carries the
                # DNF verdict for any later resume/report to read
                meta = {
                    **meta,
                    "dnf_reason": verdict["dnf_reason"],
                    "dnf_at_iter": verdict["at_iter"],
                }
        with obs_trace.span("snapshot", step=done):
            save_run_checkpoint(
                checkpoint_dir, state, _concat_diags(parts), metadata=meta
            )
        if exit_after is not None and done >= int(exit_after):
            os._exit(0)   # crash injection: die AT a checkpoint boundary
        if verdict is not None and not verdict["healthy"]:
            break
    return state, _concat_diags(parts)


def remap_membership(state: Any, old_g: Any, new_g: Any) -> Any:
    """Restore a RunState snapshot onto a DIFFERENT live-agent set.

    Agents are index-aligned (agent ``i`` of the old roster is agent ``i``
    of the new one while ``i < min(m_old, m_new)``; higher indices departed
    or joined):

    * a surviving agent keeps its ``U``/``A`` (and ``hist`` rows) bitwise;
    * a JOINING agent (index >= old m) warm-starts ``U``/``A`` from the
      mean of its surviving ``new_g`` neighbors (the all-ones initial
      state when it joins into isolation), with its ``hist`` slots seeded
      to that warm start;
    * a dual follows its undirected edge: same orientation copies bitwise,
      a flipped orientation negates (the consensus problem is
      orientation-invariant up to the dual's sign), an edge with no
      surviving counterpart starts from the zero initial dual;
    * ``k`` is untouched.

    ``remap_membership(state, g, g)`` returns the state unchanged.  Only
    the dense per-edge dual layout (``lam.shape[0] == old_g.n_edges``) is
    remappable.  The result's leaves are on the state's device.
    """
    fields = state._asdict()
    lam = fields["lam"]
    if lam.shape[0] != old_g.n_edges:
        raise ValueError(
            f"remap_membership needs the dense per-edge dual layout "
            f"(lam leading axis E={old_g.n_edges}); got lam.shape="
            f"{tuple(lam.shape)}."
        )
    m_old, m_new = int(old_g.m), int(new_g.m)
    n_keep = min(m_old, m_new)
    U, A = fields["U"], fields["A"]
    if U.shape[0] != m_old:
        raise ValueError(
            f"state carries {U.shape[0]} agents but old_g has m={m_old}"
        )

    U_out = U.new_ones((m_new,) + tuple(U.shape[1:]))
    A_out = A.new_ones((m_new,) + tuple(A.shape[1:]))
    U_out[:n_keep] = U[:n_keep]
    A_out[:n_keep] = A[:n_keep]
    for t in range(m_old, m_new):
        nbrs = sorted(
            {e if s == t else s for (s, e) in new_g.edges if t in (s, e)}
        )
        nbrs = [x for x in nbrs if x < n_keep]
        if nbrs:
            U_out[t] = U[nbrs].mean(dim=0)
            A_out[t] = A[nbrs].mean(dim=0)

    # orientation-aware dual matching over undirected edges
    old_idx: dict = {}
    for j, (s, e) in enumerate(old_g.edges):
        old_idx[(s, e)] = (j, False)
        old_idx[(e, s)] = (j, True)

    def remap_lam(lam_old):
        out = lam_old.new_zeros((new_g.n_edges,) + tuple(lam_old.shape[1:]))
        for j, (s, e) in enumerate(new_g.edges):
            hit = old_idx.get((s, e))
            if hit is not None and s < n_keep and e < n_keep:
                jj, flipped = hit
                out[j] = -lam_old[jj] if flipped else lam_old[jj]
        return out

    fields["U"] = U_out
    fields["A"] = A_out
    fields["lam"] = remap_lam(lam)
    hist = fields.get("hist")
    if hist is not None:
        h_out = hist.new_empty((hist.shape[0], m_new) + tuple(hist.shape[2:]))
        h_out[:, :n_keep] = hist[:, :n_keep]
        h_out[:, n_keep:] = U_out[None, n_keep:]
        fields["hist"] = h_out
    return type(state)(**fields)
