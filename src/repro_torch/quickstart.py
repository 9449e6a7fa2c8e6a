"""Quickstart: the paper's algorithms on a synthetic multi-task problem.

Builds 8 related tasks sharing a low-rank predictive subspace, then fits
  * Local ELM          (per-task baseline, eq. 4)
  * MTL-ELM            (centralized, Algorithm 1)
  * DMTL-ELM           (decentralized consensus ADMM on a ring, Algorithm 2)
  * FO-DMTL-ELM        (first-order variant, Algorithm 3)
  * DMTL-ELM (GS)      (colored Gauss-Seidel sweeps, ``fit_colored``)
and prints test errors: multi-task sharing should win by a wide margin.
The three consensus fits start from :func:`tilted_start`, not the engine's
symmetric all-ones start, so that their result does not depend on roundoff.

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

``--resume`` instead shows the checkpointed runtime on the paper's
Fig. 2(a) federation: phase 1 fits with periodic checkpoints but stops at
``--interrupt-at`` (a simulated preemption); phase 2 calls the SAME entry
point with ``resume=True`` and continues from disk to the full iteration
budget, then checks that the resumed state and the whole diagnostics
trajectory are BITWISE those of an uninterrupted run.

Run:  PYTHONPATH=src python -m repro_torch.quickstart --resume \
          [--checkpoint-dir DIR] [--iters N] [--interrupt-at K] \
          [--checkpoint-every E] [--device cpu]

``--trace`` shows the observability layer (``repro_torch.obs``): one
DMTL-ELM fit with ``telemetry=True`` (per-iteration comm counters in the
diagnostics) and ``trace_dir=`` (span tracing), then validates the exported
Chrome-format ``trace.json`` (load it in Perfetto), checks that the run
report is healthy and prints ``TRACE_OK``.

Run:  PYTHONPATH=src python -m repro_torch.quickstart --trace \
          [--trace-dir DIR] [--iters N] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import torch

from repro_torch.core import (
    DMTLELMConfig, MTLELMConfig, elm_fit, fit, mtl_elm_fit_from_stats,
    paper_fig2a, ring, sufficient_stats,
)
from repro_torch.core.engine import make_runner
from repro_torch.data.synthetic import multitask_regression

TILT = 0.1


def tilted_start(state):
    """The engine's all-ones start with column j of every U_t tilted by
    ``TILT * j * linspace(-1, 1, L)``.

    The all-ones start is symmetric in the r columns of U: in exact
    arithmetic they stay equal (the fit never leaves rank 1), and only
    roundoff splits them, so the stationary point a 2000-iteration run
    ends at depends on the device's summation order.  From the tilted start
    the end point is set by the data."""
    L, r = state.U.shape[-2:]
    kw = dict(dtype=state.U.dtype, device=state.U.device)
    ramp = torch.linspace(-1.0, 1.0, L, **kw)[:, None] * torch.arange(r, **kw)
    return state._replace(U=state.U + TILT * ramp)


def fit_from_tilted_start(stats, g, cfg, executor: str = "dense"):
    """``fit_dense`` (or ``fit_colored`` with ``executor="colored"``) from
    :func:`tilted_start`: (U, A, diagnostics)."""
    runner = make_runner(stats, g, cfg, executor=executor)
    state, diags = runner.run(tilted_start(runner.init_state()))
    return state.U, state.A, diags


def run(H_tr, T_tr, H_te, T_te, r: int = 2, mu: float = 0.1,
        mtl_iters: int = 150, dmtl_iters: int = 2000) -> dict:
    """Fit the four methods on the given data; returns each test MSE and
    the run's final diagnostics."""
    m = H_tr.shape[0]

    def mse(pred):
        return float(torch.mean((pred - T_te) ** 2))

    betas = elm_fit(H_tr, T_tr, mu)
    err_local = mse(H_te @ betas)

    # Reduce the data ONCE; every algorithm below fits from the same stats
    # (on the card: one launch of the triangular Gram kernel).
    stats = sufficient_stats(H_tr, T_tr)

    st, objs = mtl_elm_fit_from_stats(
        stats, MTLELMConfig(r=r, mu1=mu, mu2=mu, iters=mtl_iters))
    err_mtl = mse(H_te @ st.U @ st.A)

    cfg = DMTLELMConfig(r=r, mu1=mu, mu2=mu, tau=1.0, zeta=1.0,
                        iters=dmtl_iters)
    U, A, diag = fit_from_tilted_start(stats, ring(m), cfg)
    err_dmtl = mse(H_te @ U @ A)

    U, A, _ = fit_from_tilted_start(
        stats, ring(m), dataclasses.replace(cfg, first_order=True))
    err_fo = mse(H_te @ U @ A)

    # Gauss-Seidel colored sweeps: the same agent update, one color class at
    # a time with fresh neighbor messages between classes.  GS reaches the
    # frozen-dual fixed point fast enough that the adaptive gamma can
    # collapse early; gamma_floor keeps the dual ascent alive.
    U, A, diag_gs = fit_from_tilted_start(
        stats, ring(m), dataclasses.replace(cfg, gamma_floor=0.05),
        executor="colored")
    err_gs = mse(H_te @ U @ A)
    return {
        "local": err_local, "mtl": err_mtl, "dmtl": err_dmtl, "fo": err_fo,
        "gs": err_gs,
        "mtl_objective": (float(objs[0]), float(objs[-1])),
        "dmtl_consensus": float(diag["consensus"][-1]),
        "gs_consensus": float(diag_gs["consensus"][-1]),
    }


def main(device="cuda", seed: int = 0) -> dict:
    m, r = 8, 2
    H_tr, T_tr, H_te, T_te = multitask_regression(
        seed, m=m, n_train=16, n_test=300, L=64, r=r, noise=0.1,
        device=device,
    )
    res = run(H_tr, T_tr, H_te, T_te, r=r)
    print(f"Local ELM      test MSE: {res['local']:.5f}")
    print(f"MTL-ELM        test MSE: {res['mtl']:.5f}  (objective "
          f"{res['mtl_objective'][0]:.2f} -> {res['mtl_objective'][1]:.2f})")
    print(f"DMTL-ELM       test MSE: {res['dmtl']:.5f}  "
          f"(consensus residual {res['dmtl_consensus']:.2e})")
    print(f"FO-DMTL-ELM    test MSE: {res['fo']:.5f}")
    print(f"DMTL-ELM (GS)  test MSE: {res['gs']:.5f}  (colored sweeps, "
          f"consensus {res['gs_consensus']:.2e})")
    if not all(res[k] < res["local"] for k in ("mtl", "dmtl", "gs")):
        raise AssertionError(f"multi-task sharing did not beat local: {res}")
    print("multi-task sharing beats local training ✓")
    return res


def resume_demo(checkpoint_dir="quickstart_ckpt", iters: int = 600,
                interrupt_at: int = 0, checkpoint_every: int = 100,
                device="cuda", seed: int = 0) -> dict:
    """Interrupt-and-continue on the Fig. 2(a) federation (5 agents).
    ``interrupt_at=0`` stops phase 1 at ``iters // 3``."""
    g = paper_fig2a()
    H_tr, T_tr, H_te, T_te = multitask_regression(
        seed, m=g.m, n_train=16, n_test=300, L=64, r=2, noise=0.1,
        device=device,
    )
    cfg = DMTLELMConfig(r=2, mu1=0.1, mu2=0.1, tau=1.0, zeta=1.0,
                        iters=iters)
    interrupt_at = interrupt_at or iters // 3

    # Phase 1: fit with periodic checkpoints, "preempted" at interrupt_at
    # (the same entry point with a truncated iteration budget).
    fit(H_tr, T_tr, g, dataclasses.replace(cfg, iters=interrupt_at),
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)
    print(f"phase 1: interrupted at iteration {interrupt_at}, "
          f"checkpoints under {checkpoint_dir}")

    # Phase 2: resume from the latest snapshot and run to the full budget.
    st, diag = fit(H_tr, T_tr, g, cfg, checkpoint_dir=checkpoint_dir,
                   checkpoint_every=checkpoint_every, resume=True)
    err = float(torch.mean((H_te @ st.U @ st.A - T_te) ** 2))
    print(f"phase 2: resumed {interrupt_at} -> {cfg.iters}, "
          f"test MSE {err:.5f}, "
          f"consensus {float(diag['consensus'][-1]):.2e}")

    # The contract: resumed == uninterrupted, bitwise, state AND trajectory.
    st0, diag0 = fit(H_tr, T_tr, g, cfg)
    for name in ("U", "A", "lam"):
        if not torch.equal(getattr(st, name), getattr(st0, name)):
            raise AssertionError(f"resumed {name} differs from the "
                                 f"uninterrupted run")
    if set(diag) != set(diag0):
        raise AssertionError(f"diagnostics keys {sorted(diag)} != "
                             f"{sorted(diag0)}")
    for key in diag0:
        if not torch.equal(diag[key], diag0[key]):
            raise AssertionError(f"resumed diagnostics {key!r} differ from "
                                 f"the uninterrupted run")
    print("resumed run is bitwise identical to the uninterrupted run ✓")
    return {"test_mse": err, "state": st, "diags": diag}


def trace_demo(trace_dir="quickstart_trace", iters: int = 600,
               device="cuda", seed: int = 0) -> dict:
    """One telemetry-on traced fit: counters, spans, and the run report."""
    from repro_torch.obs import validate_trace

    m, r = 8, 2
    g = ring(m)
    H_tr, T_tr, H_te, T_te = multitask_regression(
        seed, m=m, n_train=16, n_test=300, L=64, r=r, noise=0.1,
        device=device,
    )
    cfg = DMTLELMConfig(r=r, mu1=0.1, mu2=0.1, tau=1.0, zeta=1.0,
                        iters=iters)
    st, diag = fit(H_tr, T_tr, g, cfg, telemetry=True, trace_dir=trace_dir)
    err = float(torch.mean((H_te @ st.U @ st.A - T_te) ** 2))

    trace_dir = Path(trace_dir)
    n_events = validate_trace(trace_dir / "trace.json")
    report = json.loads((trace_dir / "report.json").read_text())
    delivered = float(diag["msgs_delivered"].sum())
    floats_per_iter = float(diag["comm_floats"][0])
    print(f"test MSE {err:.5f}, "
          f"consensus {float(diag['consensus'][-1]):.2e}")
    print(f"trace: {n_events} spans in {trace_dir / 'trace.json'} "
          f"(Chrome trace format — open in Perfetto)")
    print(f"comm: {delivered:.0f} subspace messages delivered, "
          f"{floats_per_iter:.0f} floats/iteration (analytic model)")
    print(f"report: {trace_dir / 'report.md'} "
          f"(health: {report['health']['dnf_reason'] or 'healthy'})")
    if not report["health"]["healthy"]:
        raise AssertionError(f"run report is not healthy: {report['health']}")
    print("TRACE_OK")
    return {"test_mse": err, "diags": diag, "report": report,
            "n_events": n_events}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--resume", action="store_true",
                        help="run the checkpoint/interrupt/resume demo")
    parser.add_argument("--trace", action="store_true",
                        help="run the telemetry/tracing/report demo")
    parser.add_argument("--checkpoint-dir", default="quickstart_ckpt")
    parser.add_argument("--trace-dir", default="quickstart_trace")
    parser.add_argument("--iters", type=int, default=600)
    parser.add_argument("--interrupt-at", type=int, default=0,
                        help="simulated preemption iteration (0: iters // 3)")
    parser.add_argument("--checkpoint-every", type=int, default=100)
    args = parser.parse_args()
    if args.resume:
        resume_demo(args.checkpoint_dir, args.iters, args.interrupt_at,
                    args.checkpoint_every, device=args.device,
                    seed=args.seed)
    elif args.trace:
        trace_demo(args.trace_dir, args.iters, device=args.device,
                   seed=args.seed)
    else:
        main(device=args.device, seed=args.seed)
