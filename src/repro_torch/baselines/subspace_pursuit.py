"""DGSP / DNSP [22: Wang, Kolar, Srebro 2016]: distributed multi-task
learning with a shared low-dimensional subspace, master-slave structure.

Greedy subspace pursuit: in round j each worker (task) sends the master its
local descent direction at the current restricted solution (gradient for
DGSP, Newton for DNSP); the master extracts the dominant left singular
vector of the stacked directions as the new basis column; workers then
re-solve their local regression restricted to span(U).  r rounds build an
r-dimensional shared subspace; communication is one n-vector per worker
per round, the load model of the paper's Fig. 6 comparison.

An eigenvector is fixed only up to its sign, so two implementations agree
on ``U Uᵀ`` and the predictions, not on ``U`` itself.
"""

from __future__ import annotations

import torch


def _restricted_solve(XU: torch.Tensor, Y: torch.Tensor, lam) -> torch.Tensor:
    """Per-task ridge on the projected features. XU: (m, N, j)."""
    j = XU.shape[-1]
    G = XU.mT @ XU + lam * torch.eye(j, dtype=XU.dtype, device=XU.device)
    return torch.linalg.solve(G, XU.mT @ Y)                 # (m, j, d)


def _pursuit(X: torch.Tensor, Y: torch.Tensor, r: int, lam, newton: bool):
    m, N, n = X.shape
    d = Y.shape[-1]
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    XtX = X.mT @ X
    U = X.new_zeros((n, 0))
    for j in range(r):
        if j == 0:
            resid = -Y                                       # w = 0
        else:
            XU = X @ U
            resid = XU @ _restricted_solve(XU, Y, lam) - Y
        grad = X.mT @ resid                                  # (m, n, d)
        if newton:
            grad = torch.linalg.solve(XtX + lam * eye, grad)
        D = grad.permute(1, 0, 2).reshape(n, m * d)
        # dominant left singular vector of the stacked directions
        _, vecs = torch.linalg.eigh(D @ D.mT + 1e-12 * eye)
        u = vecs[:, -1:]
        if j > 0:
            u = u - U @ (U.mT @ u)                           # re-orthogonalize
            u = u / torch.clamp(torch.linalg.norm(u), min=1e-9)
        U = torch.cat([U, u], dim=1)
    XU = X @ U
    return U, _restricted_solve(XU, Y, lam)


def dgsp_fit(X: torch.Tensor, Y: torch.Tensor, r: int = 10,
             lam: float = 10.0):
    return _pursuit(X, Y, r, lam, newton=False)


def dnsp_fit(X: torch.Tensor, Y: torch.Tensor, r: int = 10,
             lam: float = 10.0):
    return _pursuit(X, Y, r, lam, newton=True)


def sp_predict(U: torch.Tensor, A: torch.Tensor,
               X: torch.Tensor) -> torch.Tensor:
    return X @ U @ A
