"""Convex Multi-Task Feature Learning (MTFL) [5: Argyriou, Evgeniou, Pontil,
Machine Learning 2008].

min_W sum_t ||X_t w_t - y_t||^2 + gamma * tr(W^T D^{-1} W),  D psd, tr(D)<=1.

Alternating solution:
  W-step: per-task generalized ridge   w_t = (X^T X + gamma D^{-1})^{-1} X^T y
  D-step: D = (W W^T)^{1/2} / tr((W W^T)^{1/2}), smoothed by eps.
"""

from __future__ import annotations

import torch


def _msqrt(M: torch.Tensor) -> torch.Tensor:
    vals, vecs = torch.linalg.eigh(M)
    vals = torch.clamp(vals, min=0.0)
    return (vecs * torch.sqrt(vals)) @ vecs.mT


def mtfl_fit(X: torch.Tensor, Y: torch.Tensor, gamma: float = 10.0,
             eps: float = 1e-3, iters: int = 30) -> torch.Tensor:
    """X: (m, N, n_in); Y: (m, N, d). Returns W: (m, n_in, d), the W-step
    of the last of ``iters`` alternations."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    m, N, n = X.shape
    d = Y.shape[-1]
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    D = eye / n
    XtX = X.mT @ X
    XtY = X.mT @ Y
    for _ in range(iters):
        D_inv = torch.linalg.inv(D + eps * eye)
        W = torch.linalg.solve(XtX + gamma * D_inv, XtY)      # (m, n, d)
        Wm = W.reshape(m, n * d).mT.reshape(n, m * d)         # task columns
        sq = _msqrt(Wm @ Wm.mT)
        D = sq / torch.clamp(torch.trace(sq), min=1e-9)
    return W


def mtfl_predict(W: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """W: (m, n, d); X: (m, N, n) -> (m, N, d)."""
    return X @ W
