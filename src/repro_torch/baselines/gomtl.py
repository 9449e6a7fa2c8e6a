"""GO-MTL [8: Kumar & Daume III, ICML 2012]: task grouping and overlap,
W = L S with shared dictionary L (n x k) and sparse task codes S (k x m).

Alternating optimization:
  S-step: per-task ISTA (lasso) on fixed L;
  L-step: ridge least squares on fixed S.

The start ``L0`` is an argument: the reference draws it from
``jax.random.normal(key, (n, k)) / sqrt(n)``, a stream torch cannot
replay, so a caller that wants the reference's fit passes that draw in.
"""

from __future__ import annotations

import torch


def _soft(x: torch.Tensor, lam) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(torch.abs(x) - lam, min=0.0)


def gomtl_fit(X: torch.Tensor, Y: torch.Tensor, L0: torch.Tensor,
              lam_s: float = 0.1, lam_l: float = 1e-3, iters: int = 40,
              ista_steps: int = 25):
    """X: (m, N, n); Y: (m, N, d); L0: (n, k), the dictionary's start.
    Returns (L (n, k), S (m, k, d))."""
    m, N, n = X.shape
    d = Y.shape[-1]
    k = L0.shape[1]
    L = L0.to(dtype=X.dtype, device=X.device)
    S = X.new_zeros((m, k, d))
    XtX = X.mT @ X
    XtY = X.mT @ Y
    eye = torch.eye(n * k, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        # S-step: ISTA per task on 1/2||X L s - y||^2 + lam_s ||s||_1
        G = L.mT @ XtX @ L                                   # (m, k, k)
        lips = torch.linalg.eigvalsh(G)[..., -1][:, None, None] + 1e-6
        R = L.mT @ XtY                                       # (m, k, d)
        for _ in range(ista_steps):
            S = _soft(S - (G @ S - R) / lips, lam_s / lips)
        # L-step: vec(L) ridge solve  sum_t (S_t S_t^T kron X_t^T X_t)
        A = S @ S.mT                                         # (m, k, k)
        K = torch.einsum("mij,mkl->ikjl", XtX, A).reshape(n * k, n * k)
        rhs = torch.einsum("mid,mkd->ik", XtY, S).reshape(-1)
        L = torch.linalg.solve(K + lam_l * eye, rhs).reshape(n, k)
    return L, S


def gomtl_predict(L: torch.Tensor, S: torch.Tensor,
                  X: torch.Tensor) -> torch.Tensor:
    return X @ L @ S
