"""MTL-ELM — centralized multi-task ELM (paper §II-B, Algorithm 1).

Solves eq. (6):
    min_{U, A}  sum_t 1/2 ||H_t U A_t - T_t||^2 + mu1/2 ||U||^2 + mu2/2 ||A||^2
by Alternating Optimization:
    U-step  (eq. 9): vectorized Kronecker ridge solve over all tasks;
    A-step (eq. 11): per-task (r x r) ridge solve.

Both steps are functions of the sufficient statistics alone, so
``mtl_elm_fit`` reduces the data once through the Gram producer and
``mtl_elm_fit_from_stats`` runs the whole algorithm from stats.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.engine import (
    SufficientStats,
    objective_from_stats,
    sufficient_stats,
)
from repro_torch.core.solvers import kron_ridge_solve, sum_sylvester_cg


class MTLELMState(NamedTuple):
    U: torch.Tensor  # (L, r) shared subspace
    A: torch.Tensor  # (m, r, d) task heads


@dataclasses.dataclass(frozen=True)
class MTLELMConfig:
    r: int
    mu1: float = 2.0
    mu2: float = 2.0
    iters: int = 100
    u_solver: str = "kron"  # "kron" (paper eq. 9) | "cg" (matrix-free)


def mtl_objective(H, T, U, A, mu1: float, mu2: float) -> torch.Tensor:
    """Paper eq. (6). H: (m, N, L); T: (m, N, d)."""
    resid = H @ U @ A - T
    return (
        0.5 * torch.sum(resid**2)
        + 0.5 * mu1 * torch.sum(U**2)
        + 0.5 * mu2 * torch.sum(A**2)
    )


def _update_U(stats: SufficientStats, A, mu1, solver):
    """Paper eq. (9): solve sum_t G_t U A_t A_t^T + mu1 U = sum_t R_t A_t^T."""
    Ms = A @ A.mT                                  # (m, r, r)  A_t A_t^T
    R = torch.sum(stats.R @ A.mT, dim=0)           # (L, r)     sum R_t A_t^T
    if solver == "kron":
        return kron_ridge_solve(stats.G, Ms, R, mu1)
    return sum_sylvester_cg(stats.G, Ms, R, mu1)


def _update_A(stats: SufficientStats, U, mu2):
    """Paper eq. (11), batched over tasks: (U^T G_t U + mu2 I)^-1 U^T R_t."""
    r = U.shape[1]
    Ga = U.mT @ stats.G @ U + mu2 * torch.eye(r, dtype=U.dtype,
                                              device=U.device)
    return torch.linalg.solve(Ga, U.mT @ stats.R)


def mtl_elm_fit_from_stats(
    stats: SufficientStats, cfg: MTLELMConfig,
) -> tuple[MTLELMState, torch.Tensor]:
    """Run Algorithm 1 over sufficient statistics alone.  Returns the final
    state and the (iters,) per-iteration objective."""
    if cfg.u_solver not in ("kron", "cg"):
        raise ValueError(f"unknown u_solver {cfg.u_solver!r}; 'kron' or 'cg'")
    m, L = stats.G.shape[0], stats.G.shape[-1]
    d = stats.R.shape[-1]
    dtype, device = stats.G.dtype, stats.G.device
    U = torch.zeros((L, cfg.r), dtype=dtype, device=device)
    A = torch.ones((m, cfg.r, d), dtype=dtype, device=device)
    objs = []
    for _ in range(cfg.iters):
        U = _update_U(stats, A, cfg.mu1, cfg.u_solver)
        A = _update_A(stats, U, cfg.mu2)
        objs.append(objective_from_stats(stats, U, A, cfg.mu1, cfg.mu2,
                                         shared_u=True))
    objs = torch.stack(objs) if objs else torch.zeros((0,), dtype=dtype,
                                                      device=device)
    return MTLELMState(U, A), objs


def mtl_elm_fit(H, T, cfg: MTLELMConfig, use_kernel: bool = True):
    """Run Algorithm 1.  H: (m, N, L) hidden features per task; T: (m, N, d).
    Initialization A_t^0 = 1 (all-ones), as in the paper."""
    return mtl_elm_fit_from_stats(sufficient_stats(H, T, use_kernel), cfg)


def mtl_elm_predict(U, A_t, H) -> torch.Tensor:
    """Predict task-t outputs from hidden features H (N, L)."""
    return H @ U @ A_t
