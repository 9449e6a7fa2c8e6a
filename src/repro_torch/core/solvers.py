"""Dense linear-algebra solvers shared by the MTL/DMTL algorithms.

Three solve strategies for the U-update family ``sum_t G_t U M_t + c U = R``:

1. ``kron_ridge_solve`` — the paper's own formulation (eq. 9 / eq. 19): the
   vectorized ``(L r, L r)`` Kronecker system.  Faithful but O(L^3 r^3).
2. ``sylvester_ridge_solve`` — the same equation for one term by double
   eigendecomposition in O(L^3 + r^3).
3. ``sum_sylvester_cg`` — matrix-free (preconditioned) conjugate gradients;
   ``gram_diag_precond`` is the Gram-diagonal (Jacobi) preconditioner.

Batching: the reference runs one system per call and vmaps over agents.
Here every solver takes optional leading batch axes (one independent system
per batch element): ``Gs (..., t, L, L)``, ``Ms (..., t, r, r)``,
``R (..., L, r)`` and ``c`` a scalar or ``(...)``.  Without batch axes the
semantics are exactly the reference's.
"""

from __future__ import annotations

from typing import Callable

import torch


def _scalar_bc(c, like: torch.Tensor) -> torch.Tensor:
    """A scalar or per-batch ``c`` shaped to broadcast against (..., L, r)."""
    c = torch.as_tensor(c, dtype=like.dtype, device=like.device)
    return c[..., None, None]


def ridge_solve(H: torch.Tensor, T: torch.Tensor, mu: float) -> torch.Tensor:
    """Closed-form regularized ELM solve (paper eq. 4): (H^T H + mu I)^-1 H^T T,
    by Cholesky (G + mu I is SPD for mu > 0)."""
    L = H.shape[-1]
    G = H.mT @ H + mu * torch.eye(L, dtype=H.dtype, device=H.device)
    return torch.cholesky_solve(H.mT @ T, torch.linalg.cholesky(G))


def _vec_cm(x: torch.Tensor) -> torch.Tensor:
    """Column-major vectorization, matching vec(AXB) = (B^T kron A) vec(X)."""
    return x.mT.reshape(*x.shape[:-2], -1)


def _unvec_cm(v: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    return v.reshape(*v.shape[:-1], cols, rows).mT


def kron_ridge_solve(Gs, Ms, R, c) -> torch.Tensor:
    """Solve sum_t G_t U M_t + c U = R via the vectorized Kronecker system.

    Gs: (..., t, L, L) symmetric (or (L, L)); Ms: (..., t, r, r) symmetric
    (or (r, r)); R: (..., L, r); c scalar or (...).  Paper eq. (9); eq. (19)
    is the one-term case."""
    if Gs.ndim == 2:
        Gs, Ms = Gs[None], Ms[None]
    L, r = R.shape[-2:]
    # vec(G U M) = (M^T kron G) vec(U); M symmetric
    K = torch.einsum("...tij,...tkl->...ikjl", Ms, Gs)
    K = K.reshape(*K.shape[:-4], L * r, L * r)
    eye = torch.eye(L * r, dtype=R.dtype, device=R.device)
    K = K + _scalar_bc(c, R) * eye
    v = torch.linalg.solve(K, _vec_cm(R))
    return _unvec_cm(v, L, r)


def sylvester_ridge_solve(G, M, R, c, eig_g=None) -> torch.Tensor:
    """Solve G U M + c U = R for symmetric PSD G (..., L, L), M (..., r, r)
    exactly: in the eigenbases the operator is diagonal, ``Dg_i Dm_j + c``.
    ``eig_g`` is an optional precomputed ``eigh(G)`` (G is iteration-
    invariant in the ADMM loops, so callers hoist it)."""
    dg, qg = torch.linalg.eigh(G) if eig_g is None else eig_g
    dm, qm = torch.linalg.eigh(M)
    Rt = qg.mT @ R @ qm
    denom = dg[..., :, None] * dm[..., None, :] + _scalar_bc(c, R)
    return qg @ (Rt / denom) @ qm.mT


def _bdot(a: torch.Tensor, b: torch.Tensor, nb: int) -> torch.Tensor:
    """Inner products over every axis after the first ``nb`` batch axes."""
    return (a * b).reshape(*a.shape[:nb], -1).sum(-1)


def cg_solve(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    tol: float = 1e-6,
    maxiter: int = 200,
    precond: Callable[[torch.Tensor], torch.Tensor] | None = None,
    return_info: bool = False,
    batch_dims: int = 0,
):
    """(Preconditioned) conjugate gradients for an SPD operator.

    ``precond`` applies M^-1 for an SPD preconditioner; the stopping rule is
    on the TRUE residual ||r|| / ||b|| either way.  ``batch_dims`` leading
    axes of ``b`` hold independent systems (``matvec`` maps the whole
    batch): the loop runs until every system has converged or reached
    ``maxiter``, and a system that is done keeps its state while the others
    iterate — the semantics of the reference's CG vmapped over agents.
    Each round costs one host sync (the any-active test).

    ``return_info=True`` returns ``(x, iters)``, iters per system.
    """
    nb = batch_dims
    x = torch.zeros_like(b) if x0 is None else x0
    apply_m = precond if precond is not None else (lambda v: v)
    r = b - matvec(x)
    z = apply_m(r)
    p = z
    rz = _bdot(r, z, nb)
    rs = _bdot(r, r, nb)
    b2 = torch.clamp(_bdot(b, b, nb), min=1e-30)
    it = torch.zeros(b.shape[:nb], dtype=torch.int64, device=b.device)
    bshape = b.shape[:nb] + (1,) * (b.ndim - nb)
    while True:
        active = (rs / b2 > tol * tol) & (it < maxiter)
        if not bool(active.any()):
            break
        ap = matvec(p)
        alpha = rz / torch.clamp(_bdot(p, ap, nb), min=1e-30)
        x_n = x + alpha.reshape(bshape) * p
        r_n = r - alpha.reshape(bshape) * ap
        z = apply_m(r_n)
        rz_n = _bdot(r_n, z, nb)
        rs_n = _bdot(r_n, r_n, nb)
        p_n = z + (rz_n / torch.clamp(rz, min=1e-30)).reshape(bshape) * p
        a = active.reshape(bshape)
        x = torch.where(a, x_n, x)
        r = torch.where(a, r_n, r)
        p = torch.where(a, p_n, p)
        rz = torch.where(active, rz_n, rz)
        rs = torch.where(active, rs_n, rs)
        it = it + active.to(it.dtype)
    return (x, it) if return_info else x


def gram_diag_precond(Gs, Ms, c) -> Callable[[torch.Tensor], torch.Tensor]:
    """Gram-diagonal (Jacobi) preconditioner of U -> sum_t G_t U M_t + c U.

    The operator's exact diagonal at (l, s) is ``sum_t G_t[l, l] M_t[s, s]
    + c``, built from the Gram diagonals alone."""
    if Gs.ndim == 2:
        Gs, Ms = Gs[None], Ms[None]
    dG = torch.diagonal(Gs, dim1=-2, dim2=-1)   # (..., t, L)
    dM = torch.diagonal(Ms, dim1=-2, dim2=-1)   # (..., t, r)
    denom = torch.einsum("...tl,...ts->...ls", dG, dM) + _scalar_bc(c, dG)
    denom = torch.clamp(denom, min=1e-30)
    return lambda v: v / denom


def sum_sylvester_cg(Gs, Ms, R, c, tol: float = 1e-8, maxiter: int = 500,
                     precond: str | None = None, return_info: bool = False):
    """Matrix-free solve of sum_t G_t U M_t + c U = R with (P)CG.

    ``precond="jacobi"`` enables :func:`gram_diag_precond`; ``None`` is plain
    CG.  Leading batch axes of R (and Gs/Ms before their t axis) are
    independent systems."""
    if Gs.ndim == 2:
        Gs, Ms = Gs[None], Ms[None]
    cb = _scalar_bc(c, R)

    def matvec(u):
        return torch.einsum("...tij,...jk,...tkl->...il", Gs, u, Ms) + cb * u

    if precond is None:
        pc = None
    elif precond == "jacobi":
        pc = gram_diag_precond(Gs, Ms, c)
    else:
        raise ValueError(f"unknown precond {precond!r}; None or 'jacobi'")
    return cg_solve(matvec, R, tol=tol, maxiter=maxiter, precond=pc,
                    return_info=return_info, batch_dims=R.ndim - 2)
