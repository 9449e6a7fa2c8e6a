"""DMTL-ELM — decentralized multi-task ELM (paper §III, Algorithm 2) and its
first-order variant FO-DMTL-ELM (Algorithm 3): the entry point.

Problem (eq. 12):
    min_{U, A} sum_t ( 1/2 ||H_t U_t A_t - T_t||^2 + mu1/(2m) ||U_t||^2
                       + mu2/2 ||A_t||^2 )      s.t.  sum_t C_t U_t = 0,
with edge-consensus constraints over a connected graph, solved by a hybrid
Jacobian (across agents) / Gauss-Seidel (U then A within an agent) proximal
multi-block ADMM.  The data are reduced to
:class:`~repro_torch.core.engine.SufficientStats` once, then
``engine.fit_dense`` (or the colored Gauss-Seidel sweep
``engine.fit_colored``) runs the iterations.

Solver choice (cfg.u_solver — ``engine.U_SOLVERS``): "kron" (the paper's
eq. 19), "sylvester" (exact, eigh(G_t) hoisted), "cg", "pcg" (Jacobi-
preconditioned CG, the backbone-scale choice); cfg.first_order=True needs
no solve at all (eq. 23).
"""

from __future__ import annotations

import torch

from repro_torch.core import engine
from repro_torch.core.engine import ConsensusConfig, DenseState
from repro_torch.core.graph import Graph

DMTLELMConfig = ConsensusConfig
DMTLELMState = DenseState

EXECUTORS = ("dense", "colored", "async", "sharded")


def augmented_lagrangian(H, T, U, A, lam, S, mu1, mu2, rho) -> torch.Tensor:
    """Paper eq. (13). S: signed incidence (E, m)."""
    m = H.shape[0]
    resid = H @ U @ A - T
    f = 0.5 * torch.sum(resid**2)
    g1 = 0.5 * mu1 / m * torch.sum(U**2)
    g2 = 0.5 * mu2 * torch.sum(A**2)
    CU = torch.einsum("em,mlr->elr", S, U)  # edge residuals U_s - U_e
    return f + g1 + g2 + torch.sum(lam * CU) + 0.5 * rho * torch.sum(CU**2)


def consensus_residual(U: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """RMS edge disagreement ||C U|| / sqrt(E L r)."""
    CU = torch.einsum("em,mlr->elr", S, U)
    return torch.sqrt(torch.mean(CU**2))


def dmtl_objective(H, T, U, A, mu1, mu2) -> torch.Tensor:
    """The primal objective of eq. (12) (no dual/penalty terms)."""
    m = H.shape[0]
    resid = H @ U @ A - T
    return (
        0.5 * torch.sum(resid**2)
        + 0.5 * mu1 / m * torch.sum(U**2)
        + 0.5 * mu2 * torch.sum(A**2)
    )


def dmtl_elm_fit(H, T, g: Graph, cfg: DMTLELMConfig, feature_map=None,
                 use_kernel: bool = True) -> tuple[DMTLELMState, dict]:
    """Run Algorithm 2 (or 3 if cfg.first_order) to cfg.iters on the dense
    executor.  H: (m, N, L) — or the raw X (m, N, d_in) with
    ``cfg.stats_producer="fused"`` and ``feature_map=`` — and T: (m, N, d)."""
    return fit(H, T, g, cfg, feature_map=feature_map, use_kernel=use_kernel)


def _not_ported(what: str, slice_name: str):
    return NotImplementedError(
        f"{what} is not ported yet: it belongs to port {slice_name}"
    )


def fit(
    H: torch.Tensor,
    T: torch.Tensor,
    g: Graph,
    cfg: DMTLELMConfig,
    *,
    executor: str = "dense",
    schedule=None,
    staleness: int = 0,
    order: str = "fixed",
    feature_map=None,
    use_kernel: bool = True,
    checkpoint_dir=None,
    telemetry: bool = False,
    trace_dir=None,
    health=None,
) -> tuple[DMTLELMState, dict]:
    """The DMTL-ELM entry point: stats pass, then the consensus iterations.

    ``executor="dense"`` is the synchronous Jacobian sweep;
    ``executor="colored"`` the Gauss-Seidel colored sweep
    (``engine.fit_colored``, with ``schedule=``, ``staleness=`` and
    ``order=``, which apply to it alone).  "async" belongs to port slice 2
    (netsim), "sharded" to slice 3.  ``cfg.stats_precision`` picks the
    Gram pass's precision ("fp32" | "bf16" | "int8").  The stats pass
    honors ``cfg.stats_producer``: with
    ``"fused"`` the first argument is the RAW per-agent input X
    (m, N, d_in) and ``feature_map=`` is required, the hidden layer running
    inside the Gram kernel.  ``use_kernel=False`` takes the Gram kernels'
    plain versions on any device.  Checkpointing, telemetry, tracing and
    health monitoring are later slices and raise rather than being ignored.

    Returns ``(DMTLELMState, diagnostics)`` with per-iteration
    'objective', 'lagrangian', 'consensus', 'gamma', 'gamma_min' and
    'primal_sq'."""
    # All validation happens BEFORE the Gram reduction.
    if executor not in EXECUTORS:
        raise ValueError(
            f"unknown executor {executor!r}; expected one of {EXECUTORS}"
        )
    if executor not in ("dense", "colored"):
        raise _not_ported(
            f"executor={executor!r}",
            "slice 3" if executor == "sharded" else "slice 2",
        )
    if executor != "colored" and schedule is not None:
        raise ValueError(
            "schedule= only applies to executor='colored', "
            f"got executor={executor!r}"
        )
    if executor != "colored" and staleness != 0:
        raise ValueError(
            f"staleness= only applies to executor='colored', "
            f"got executor={executor!r}"
        )
    if executor != "colored" and order != "fixed":
        raise ValueError(
            f"order= only applies to executor='colored', "
            f"got executor={executor!r}"
        )
    if checkpoint_dir is not None:
        raise _not_ported("checkpoint_dir= (checkpointed runs)", "slice 2")
    if telemetry:
        raise _not_ported("telemetry=True", "slice 2")
    if trace_dir is not None:
        raise _not_ported("trace_dir= (span tracing)", "slice 2")
    if health is not None and health is not False:
        raise _not_ported("health= (run-health monitors)", "slice 2")
    if cfg.stats_producer not in engine.STATS_PRODUCERS:
        raise ValueError(
            f"unknown cfg.stats_producer {cfg.stats_producer!r}; expected "
            f"one of {engine.STATS_PRODUCERS}"
        )
    if cfg.stats_producer == "fused" and feature_map is None:
        raise ValueError(
            "cfg.stats_producer='fused' needs feature_map= (the frozen "
            "ELMFeatureMap applied inside the Gram kernel)"
        )
    if cfg.stats_producer != "fused" and feature_map is not None:
        raise ValueError(
            "feature_map= only applies to cfg.stats_producer='fused', got "
            f"stats_producer={cfg.stats_producer!r}"
        )
    if cfg.aggregator != "mean":
        raise _not_ported(f"aggregator={cfg.aggregator!r}",
                          "slice 2, with netsim")
    stats = engine.produce_stats(
        H, T, producer=cfg.stats_producer, feature_map=feature_map,
        precision=cfg.stats_precision, use_kernel=use_kernel,
    )
    state, diags = engine.make_runner(
        stats, g, cfg, executor=executor, schedule=schedule,
        staleness=staleness, order=order).run()
    return DenseState(state.U, state.A, state.lam), diags


def dmtl_elm_predict(U_t, A_t, H) -> torch.Tensor:
    return H @ U_t @ A_t
