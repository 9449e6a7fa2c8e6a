"""One-off check of ROADMAP queue 3's "PCG at its cap": the reference's and
the port's Jacobi-preconditioned CG U-solve on one set of statistics of
``chip_smoke.py`` phase 4's shape, on the CPU.

Phase 4's inputs (8 agents, 8192 samples of 256 features, an L = 2048
normal-weight sigmoid hidden layer; its data and weights are drawn on the
host, so the CPU gets them too) give G = HᵀH and R = HᵀT in fp32.  The
system is the first ADMM iteration's U-solve of phase 4's fit (r = 8,
mu1 = 1, tau = 2, ring(8), from the all-ones start): G_t U M + c_t U = rhs_t
with M = A Aᵀ, rhs_t = R_t Aᵀ + rho sum_j U_j + p_t U_t, c_t = mu1/m +
rho d_t + p_t, p_t = tau_t - rho d_t.  Both packages solve it with their
shared defaults (tol 1e-8, maxiter 500, ``precond="jacobi"``); the script
prints each agent's step count and the final relative residual
||rhs - G U M - c U|| / ||rhs||, evaluated in fp64.

Run:  PYTHONPATH=src python tools/pcg_cap_check.py [--threads 8]
(several GiB and a few minutes of CPU).
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--threads", type=int, default=8)
    args = parser.parse_args()

    import torch

    torch.set_num_threads(args.threads)
    import jax
    import jax.numpy as jnp

    from repro.core import solvers as jsolvers
    from repro_torch.core import elm, solvers
    from repro_torch.data import synthetic

    m, L, r, mu1, tau, rho = 8, 2048, 8, 1.0, 2.0, 1.0
    data = synthetic.multitask_classification(
        0, m=m, n_train=8192, n_test=1024, n_in=256, n_cls=3, device="cpu")
    fmap = elm.make_feature_map(1, n_in=256, L=L, dist="normal", device="cpu")
    H = fmap(data.X_train)                                  # (8, 8192, 2048)
    G = (H.mT @ H).numpy()
    R = (H.mT @ data.Y_train).numpy()
    del H
    d = R.shape[-1]
    deg = 2.0                                               # ring(8)
    p_t = (tau + deg) - rho * deg
    c = np.full((m,), mu1 / m + rho * deg + p_t, np.float32)
    A = np.ones((m, r, d), np.float32)
    U = np.ones((m, L, r), np.float32)
    M = A @ A.transpose(0, 2, 1)
    rhs = (R @ A.transpose(0, 2, 1) + rho * deg * U + p_t * U).astype(
        np.float32)

    def residual(X):
        X = X.astype(np.float64)
        lhs = (G.astype(np.float64) @ X @ M.astype(np.float64)
               + c[:, None, None].astype(np.float64) * X)
        res = rhs.astype(np.float64) - lhs
        return (np.linalg.norm(res.reshape(m, -1), axis=1)
                / np.linalg.norm(rhs.astype(np.float64).reshape(m, -1),
                                 axis=1))

    X_t, it_t = solvers.sum_sylvester_cg(
        torch.tensor(G)[:, None], torch.tensor(M)[:, None], torch.tensor(rhs),
        torch.tensor(c), precond="jacobi", return_info=True)
    solve = jax.jit(jax.vmap(lambda g, mm, b, cc: jsolvers.sum_sylvester_cg(
        g, mm, b, cc, precond="jacobi", return_info=True)))
    X_j, it_j = solve(jnp.asarray(G), jnp.asarray(M), jnp.asarray(rhs),
                      jnp.asarray(c))
    print(json.dumps({
        "shape": {"m": m, "L": L, "r": r, "N": 8192},
        "port_steps": it_t.tolist(),
        "reference_steps": np.asarray(it_j).tolist(),
        "port_rel_residual": residual(X_t.numpy()).tolist(),
        "reference_rel_residual": residual(np.asarray(X_j)).tolist(),
        "solutions_rel_diff": float(
            np.abs(X_t.numpy() - np.asarray(X_j)).max()
            / np.abs(np.asarray(X_j)).max()),
    }))


if __name__ == "__main__":
    main()
