"""FO-DMTL-ELM (paper §III-C, Algorithm 3).

Identical to Algorithm 2 except the U_t-update uses the first-order
approximation (eq. 23), removing the per-iteration matrix inverse: with
prox-linear P_t = tau_t I - rho C_t^T C_t the update collapses to a scaled
gradient step.  Convergence needs the stronger
``tau_t >= L_t + rho m (delta + 1/2) sigma_max - sigma/2`` (Theorem 2).
The first-order branch lives in ``engine.agent_update``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.dmtl_elm import DMTLELMConfig, DMTLELMState, fit
from repro_torch.core.graph import Graph


def fo_dmtl_elm_fit(
    H: torch.Tensor, T: torch.Tensor, g: Graph, cfg: DMTLELMConfig,
    **fit_kw,
) -> tuple[DMTLELMState, dict]:
    """Algorithm 3 on any ported executor: :func:`dmtl_elm.fit` with
    ``first_order=True``; keyword arguments (``executor=``, ``schedule=``,
    ``staleness=``, ``order=``, ``feature_map=``, ``use_kernel=``, ...) are
    forwarded."""
    return fit(H, T, g, dataclasses.replace(cfg, first_order=True), **fit_kw)


def lipschitz_bound(H: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Estimate of the block-coordinate Lipschitz constant L_t (Prop. 2):
    L_t = ||H_t^T H_t|| * ||A_t A_t^T|| (spectral norms), per agent."""
    G = H.mT @ H
    M = A @ A.mT
    return (torch.linalg.eigvalsh(G)[..., -1]
            * torch.linalg.eigvalsh(M)[..., -1])
