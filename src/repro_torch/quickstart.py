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
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.core import (
    DMTLELMConfig, MTLELMConfig, elm_fit, mtl_elm_fit_from_stats, ring,
    sufficient_stats,
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


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    main(device=args.device, seed=args.seed)
