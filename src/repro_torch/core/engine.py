"""Stats-first consensus engine: the single-device executors.

All three of the paper's algorithms (MTL-ELM, DMTL-ELM, FO-DMTL-ELM) reduce
to per-agent updates over the sufficient statistics

    G_t = H_t^T H_t     (L, L)   feature Gram
    R_t = H_t^T T_t     (L, d)   feature-target cross terms

``sufficient_stats`` / ``sufficient_stats_fused`` / ``accumulate_stats``
    The stats producers.  With ``use_kernel=True`` (the default) a CUDA
    tensor goes through the hand-written Gram kernels (one launch of the
    triangular kernel for all m agents, the int8 kernel for
    ``precision="int8"``, or the fused ``act(X W + b)`` kernel); a CPU
    tensor, or ``use_kernel=False``, takes their plain PyTorch versions
    (for int8: the quantize-dequantize emulation on the same rounding
    draws).  Chunked accumulation is addition of producer outputs;
    ``compensated=True`` makes the chunk fold a Kahan sum.
``agent_update``
    One ADMM round (paper eqs. 19/23 + 21) for all agents at once, batched
    over the leading agent axis: the U-solve through ``U_SOLVERS``
    (``kron`` | ``sylvester`` | ``cg`` | ``pcg``), the first-order branch,
    and the local A-solve.  No communication inside.
``dual_step``
    The adaptive-gamma dual ascent (eq. 16 + Lemma 2), per edge.
``fit_dense``
    The synchronous Jacobian executor: all agents on one device, neighbor
    messages from ``exchange.DenseExchange``.
``fit_colored``
    Gauss-Seidel colored sweeps over the same body: one color class at a
    time, neighbor sums re-gathered between classes, optional message
    staleness and the Gauss-Southwell class order.
``fit_async``
    The event-tape executor of ``repro_torch.netsim``: per-edge delays,
    drops, stragglers, Byzantine senders and membership churn replayed from
    a precomputed tape around the same body.
``fit_sharded`` / ``fit_sharded_graph``
    One agent per rank of a ``torch.distributed`` process group
    (:mod:`repro_torch.core.mesh`): the ring/torus of the mesh's agent axes
    (``ring_iteration``), or any connected graph compiled to ppermute
    rounds (``exchange.ShardedGraphExchange``), with Gauss-Seidel phases
    and in-mesh tape replay.  Only U_t and edge duals cross ranks.
``AGGREGATORS``
    ``cfg.aggregator``: the plain neighbor sum ("mean") or a robust center
    ("trimmed_mean", "coordinate_median", "krum_like", or one added with
    :func:`register_aggregator`) over the received views plus the agent's
    own U, in every executor here.

Telemetry (``cfg.telemetry=True``; the observability layer,
``repro_torch.obs``): every executor additionally reports, per iteration,

  resid_max       max |C U| over the edges (worst-agent consensus)
  msgs_delivered  fresh deliveries this iteration
  msgs_stale      stale-served deliveries (colored sweeps with staleness
                  > 1, tape ticks with age > 1)
  msgs_dropped    deliveries masked out (the async executor's dead edges)
  agg_rejected    robust-aggregation rejections
                  (``exchange.aggregator_audit``; 0 on the mean path)
  comm_floats     the analytic floats-per-iteration model
                  (``repro_torch.obs.counters.modeled_floats_per_iter``)

with the reference's counts.  The gate is a plain ``if cfg.telemetry``:
with telemetry off the diagnostics' keys and every value are those of the
engine without it.  With a tracer installed (``repro_torch.obs.use``),
``produce_stats`` records a ``"stats"`` span and ``Runner.run_segment`` a
``"segment"`` span, each waiting for the device inside the span.

The reference vmaps the per-agent body and scans the iterations inside one
compiled program.  Here the agent axis is a batch dimension written out and
the iterations are a Python loop over eager PyTorch ops.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core import exchange
from repro_torch.core.graph import Graph
from repro_torch.core.solvers import (
    kron_ridge_solve,
    sum_sylvester_cg,
    sylvester_ridge_solve,
)
from repro_torch.kernels.gram import ops as gram_ops
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.counters import modeled_floats_per_iter


# --------------------------------------------------------------------------
# Sufficient statistics
# --------------------------------------------------------------------------


class SufficientStats(NamedTuple):
    """Per-agent Gram statistics; leading axes (if any) index agents.

    ``n`` (samples folded in) and ``t2`` (sum of squared targets) make the
    primal objective computable from stats alone."""

    G: torch.Tensor                  # (..., L, L)  H^T H
    R: torch.Tensor                  # (..., L, d)  H^T T
    n: torch.Tensor | float = 0.0    # (...,) samples seen
    t2: torch.Tensor | float = 0.0   # (...,) sum T**2


def _count(shape, n: int, device) -> torch.Tensor:
    return torch.full(tuple(shape), float(n), dtype=torch.float32,
                      device=device)


def _t2(T: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(T.float()), dim=(-2, -1))


def sufficient_stats(
    H: torch.Tensor, T: torch.Tensor, use_kernel: bool = True,
    precision: str = "fp32", quant_seed: int = 0,
) -> SufficientStats:
    """The MATERIALIZED stats producer.  H: (N, L) or (m, N, L); T matches.

    A stacked (m, N, L) input is ONE launch of the triangular Gram kernel
    for all m agents.  ``precision="bf16"`` streams H and T in bf16 with
    fp32 accumulation; ``precision="int8"`` quantizes H per tile with the
    rounding stream of ``quant_seed`` (``kernels.gram.ops``); ``t2`` always
    stays fp32."""
    op = gram_ops.gram if H.ndim == 2 else gram_ops.gram_batched
    G, R = op(H, T, precision=precision, force_ref=not use_kernel,
              quant_seed=quant_seed)
    return SufficientStats(G=G, R=R, n=_count(H.shape[:-2], H.shape[-2],
                                              H.device), t2=_t2(T))


def sufficient_stats_fused(
    X: torch.Tensor, feature_map, T: torch.Tensor, use_kernel: bool = True,
    precision: str = "fp32",
) -> SufficientStats:
    """The FUSED stats producer: statistics straight from raw features.

    X: (N, d_in) or (m, N, d_in); ``feature_map`` a frozen
    :class:`repro_torch.core.elm.ELMFeatureMap` shared across agents.  The
    hidden layer is computed inside the Gram kernel and never written to
    device memory."""
    G, R = gram_ops.gram_fused(
        X, feature_map.W, feature_map.b, T,
        activation=feature_map.activation, precision=precision,
        force_ref=not use_kernel,
    )
    return SufficientStats(G=G, R=R, n=_count(X.shape[:-2], X.shape[-2],
                                              X.device), t2=_t2(T))


STATS_PRODUCERS = ("materialized", "fused")


def produce_stats(
    batch: torch.Tensor, T: torch.Tensor, *, producer: str = "materialized",
    feature_map=None, use_kernel: bool = True, precision: str = "fp32",
    quant_seed: int = 0,
) -> SufficientStats:
    """Dispatch ONE batch through the configured stats producer.

    ``producer="materialized"`` treats ``batch`` as the hidden features H;
    ``producer="fused"`` treats it as raw inputs X and needs
    ``feature_map=``."""
    if producer not in STATS_PRODUCERS:
        raise ValueError(
            f"unknown stats producer {producer!r}; expected one of "
            f"{STATS_PRODUCERS}"
        )
    if producer == "fused":
        if feature_map is None:
            raise ValueError(
                "producer='fused' needs feature_map= (the frozen "
                "ELMFeatureMap whose hidden layer runs in-kernel)"
            )
        if precision == "int8":
            raise ValueError(
                "precision='int8' is the unfused (materialized) stream; "
                "the fused producer supports fp32/bf16"
            )
    elif feature_map is not None:
        raise ValueError(
            "feature_map= only applies to producer='fused', got "
            f"producer={producer!r}"
        )

    def dispatch():
        if producer == "fused":
            return sufficient_stats_fused(batch, feature_map, T,
                                          use_kernel=use_kernel,
                                          precision=precision)
        return sufficient_stats(batch, T, use_kernel=use_kernel,
                                precision=precision, quant_seed=quant_seed)

    tr = obs_trace.current()
    if tr is None:
        return dispatch()
    with tr.span("stats", producer=producer, precision=precision):
        out = dispatch()
        obs_trace.block_until_ready(out)
    return out


def init_stats(m: int, L: int, d: int, dtype=torch.float32,
               device="cuda") -> SufficientStats:
    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SufficientStats(G=z(m, L, L), R=z(m, L, d), n=z(m), t2=z(m))


def accumulate_stats(
    stats: SufficientStats, H: torch.Tensor, T: torch.Tensor,
    use_kernel: bool = True, precision: str = "fp32",
    producer: str = "materialized", feature_map=None, quant_seed: int = 0,
) -> SufficientStats:
    """Fold one batch into running stats (streaming accumulation)."""
    b = produce_stats(H, T, producer=producer, feature_map=feature_map,
                      use_kernel=use_kernel, precision=precision,
                      quant_seed=quant_seed)
    return SufficientStats(
        G=stats.G + b.G, R=stats.R + b.R, n=stats.n + b.n, t2=stats.t2 + b.t2
    )


def _kahan_add(total: torch.Tensor, comp: torch.Tensor, delta: torch.Tensor):
    """One compensated-summation step: (new_total, new_comp) with the fp32
    rounding error of ``total + delta`` carried in ``comp``."""
    y = delta - comp
    t = total + y
    return t, (t - total) - y


def accumulate_stats_chunked(
    stats: SufficientStats, H: torch.Tensor, T: torch.Tensor,
    chunk: int, use_kernel: bool = True, precision: str = "fp32",
    compensated: bool = False, producer: str = "materialized",
    feature_map=None, quant_seed: int = 0,
) -> SufficientStats:
    """Fold a long (m, B, ...) batch in ``chunk``-row pieces.

    The full chunks are folded in order; a ragged tail is ONE extra producer
    call on the true tail rows.  (Zero-padding the tail would be wrong for
    the fused producer: a zero input row maps to ``act(b) != 0``.)  ``n``
    counts the true rows and, like every leaf, comes out per-agent (m,).
    ``compensated=True`` folds through Kahan sums.  int8 chunk c rounds
    with seed ``quant_seed + c`` and the tail with ``quant_seed + k`` (k
    full chunks), so chunk errors stay independent."""
    m, B = H.shape[0], H.shape[1]
    k = B // chunk
    device = stats.G.device
    n_0 = torch.as_tensor(stats.n, dtype=torch.float32, device=device)
    t2_0 = torch.as_tensor(stats.t2, dtype=torch.float32, device=device)
    n_0, t2_0 = n_0.expand(m), t2_0.expand(m)

    def pieces():
        for c in range(k):
            yield (H[:, c * chunk:(c + 1) * chunk],
                   T[:, c * chunk:(c + 1) * chunk], quant_seed + c)
        if B > k * chunk:
            yield H[:, k * chunk:], T[:, k * chunk:], quant_seed + k

    G, R, t2 = stats.G, stats.R, t2_0
    if compensated:
        cG, cR, ct2 = (torch.zeros_like(G), torch.zeros_like(R),
                       torch.zeros_like(t2))
    for h, t, seed in pieces():
        b = produce_stats(h, t, producer=producer, feature_map=feature_map,
                          use_kernel=use_kernel, precision=precision,
                          quant_seed=seed)
        if compensated:
            G, cG = _kahan_add(G, cG, b.G)
            R, cR = _kahan_add(R, cR, b.R)
            t2, ct2 = _kahan_add(t2, ct2, b.t2)
        else:
            G, R, t2 = G + b.G, R + b.R, t2 + b.t2
    return SufficientStats(G=G, R=R, n=n_0 + B, t2=t2)


# --------------------------------------------------------------------------
# Objectives from stats alone
# --------------------------------------------------------------------------


def fit_error_from_stats(
    stats: SufficientStats, U: torch.Tensor, A: torch.Tensor
) -> torch.Tensor:
    """sum_t 0.5 ||H_t U_t A_t - T_t||^2 from (G, R, t2) only:
    ||H U A - T||^2 = tr(A^T U^T G U A) - 2 tr(A^T U^T R) + ||T||^2.
    U: (m, L, r) per agent or (L, r) shared."""
    if U.ndim == 2:
        U = U.expand((A.shape[0],) + tuple(U.shape))
    UtGU = U.mT @ stats.G @ U                              # (m, r, r)
    quad = torch.sum((UtGU @ A) * A)
    cross = torch.sum((U.mT @ stats.R) * A)
    t2 = torch.sum(torch.as_tensor(stats.t2, dtype=torch.float32,
                                   device=U.device))
    return 0.5 * (quad - 2.0 * cross + t2)


def objective_from_stats(
    stats: SufficientStats, U: torch.Tensor, A: torch.Tensor,
    mu1: float, mu2: float, shared_u: bool = False,
) -> torch.Tensor:
    """Primal objective: eq. (12) for per-agent U (mu1/(2m) ||U||^2), or
    eq. (6) for a shared U (mu1/2 ||U||^2) with ``shared_u=True``."""
    m = A.shape[0]
    u_reg = mu1 if shared_u else mu1 / m
    return (
        fit_error_from_stats(stats, U, A)
        + 0.5 * u_reg * torch.sum(U**2)
        + 0.5 * mu2 * torch.sum(A**2)
    )


# --------------------------------------------------------------------------
# Config + solver registry
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConsensusConfig:
    """Shared configuration of the DMTL-ELM / FO-DMTL-ELM family."""

    r: int
    mu1: float = 2.0
    mu2: float = 2.0
    rho: float = 1.0
    delta: float = 10.0
    # tau_t / zeta_t: proximal weights; paper uses tau_t = const + d_t.
    tau: float = 2.0             # scalar -> tau_t = tau + d_t (or per-agent array)
    zeta: float = 1.0
    iters: int = 100
    prox: str = "prox_linear"    # P_t = tau_t I - rho C_t^T C_t | "standard": tau_t I
    u_solver: str = "sylvester"  # U_SOLVERS key: "kron" | "sylvester" | "cg" | "pcg"
    # Gram-pass precision of the entry points that reduce raw data to stats
    # ("fp32" | "bf16" | "int8"; int8 is the materialized stream only).
    stats_precision: str = "fp32"
    # "materialized" computes H = g(X W + b) and streams it through the
    # triangular kernel; "fused" computes the hidden layer inside the Gram
    # kernel from raw inputs (needs feature_map= at the call site).
    stats_producer: str = "materialized"
    first_order: bool = False    # FO-DMTL-ELM (Algorithm 3)
    gamma_cap: float = 1.0       # gamma = min(cap, delta * dual/primal) as in §IV
    # Lower bound on the adaptive gamma (0 = the paper's rule untouched).
    gamma_floor: float = 0.0
    # Neighbor-aggregation rule for the consensus reduction (AGGREGATORS
    # key): "mean" is the paper's plain sum of neighbors (every executor's
    # segment-sum path, untouched); the robust rules ("trimmed_mean",
    # "coordinate_median", "krum_like") replace the mean of received
    # subspaces with a Byzantine-resilient center over the received views
    # PLUS the receiver's own U (self-inclusion keeps degree-<=2
    # reductions meaningful), scaled back by the live degree so
    # ``agent_update`` is untouched.  Mask-aware: departed/absent neighbors
    # are excluded from the candidate set rather than averaged in as zeros.
    aggregator: str = "mean"
    # Per-iteration comm/aggregator counters in the diagnostics (module
    # docstring, "Telemetry"); False keeps the diagnostics as they were.
    telemetry: bool = False


def _u_solve_kron(G, M, rhs, c, precomp=None):
    return kron_ridge_solve(G.unsqueeze(-3), M.unsqueeze(-3), rhs, c)


def _u_solve_sylvester(G, M, rhs, c, precomp=None):
    """G U M + c U = R by double eigendecomposition; ``precomp`` is the
    hoisted eigh(G) (G is iteration-invariant)."""
    return sylvester_ridge_solve(G, M, rhs, c, eig_g=precomp)


def _u_solve_cg(G, M, rhs, c, precomp=None):
    return sum_sylvester_cg(G.unsqueeze(-3), M.unsqueeze(-3), rhs, c)


def _u_solve_pcg(G, M, rhs, c, precomp=None):
    """Gram-diagonal (Jacobi) preconditioned CG, the backbone-scale solve
    where even one O(L^3) eigh per agent is undesirable."""
    return sum_sylvester_cg(G.unsqueeze(-3), M.unsqueeze(-3), rhs, c,
                            precond="jacobi")


# Each solver takes G (m, L, L), M (m, r, r), rhs (m, L, r), c (m,) and
# solves the m systems G_t U_t M_t + c_t U_t = rhs_t independently.
U_SOLVERS: dict[str, Callable] = {
    "kron": _u_solve_kron,
    "sylvester": _u_solve_sylvester,
    "cg": _u_solve_cg,
    "pcg": _u_solve_pcg,
}


def hoist_precomp(stats: SufficientStats, cfg: ConsensusConfig):
    """Iteration-invariant precomputation for the configured U-solver
    (eigh(G) for ``sylvester``, batched over agents)."""
    if cfg.u_solver == "sylvester" and not cfg.first_order:
        return torch.linalg.eigh(stats.G)
    return None


# --------------------------------------------------------------------------
# The ADMM round, batched over agents
# --------------------------------------------------------------------------


class AgentState(NamedTuple):
    U: torch.Tensor     # (m, L, r) local subspaces
    A: torch.Tensor     # (m, r, d) local heads


class NeighborMsgs(NamedTuple):
    """Everything the topology delivered to each agent this round."""

    neigh_sum: torch.Tensor  # (m, L, r)  sum_{j in N(t)} U_j^k
    ct_lam: torch.Tensor     # (m, L, r)  C_t^T lambda^k
    deg: torch.Tensor        # (m,)       degree d_t
    tau: torch.Tensor        # (m,)       resolved proximal weight tau_t
    zeta: torch.Tensor       # (m,)       resolved proximal weight zeta_t


def _bc(x: torch.Tensor) -> torch.Tensor:
    """(m,) -> (m, 1, 1) to scale per-agent (L, r) blocks."""
    return x[..., None, None]


def agent_update(
    stats: SufficientStats,
    state: AgentState,
    msgs: NeighborMsgs,
    cfg: ConsensusConfig,
    *,
    m_total: int,
    precomp=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Every agent's ADMM round (Gauss-Seidel U then A; eqs. 19/23, 21).

    Batched over the leading agent axis; all cross-agent information
    arrives in ``msgs``.  Returns (U_new, A_new); the dual update is
    :func:`dual_step`."""
    U, A = state.U, state.A
    rho, mu1 = cfg.rho, cfg.mu1
    p_t = msgs.tau - rho * msgs.deg if cfg.prox == "prox_linear" else msgs.tau

    M = A @ A.mT                                           # (m, r, r)
    rhs = stats.R @ A.mT + rho * msgs.neigh_sum - msgs.ct_lam + _bc(p_t) * U
    if cfg.first_order:
        # eq. (23): prox-linear collapses the solve to a scaled gradient step
        grad_f = stats.G @ U @ M
        U_new = (rhs - grad_f - (mu1 / m_total) * U) / _bc(rho * msgs.deg + p_t)
    else:
        if cfg.u_solver not in U_SOLVERS:
            raise ValueError(
                f"unknown u_solver {cfg.u_solver!r}; registered: "
                f"{sorted(U_SOLVERS)}"
            )
        c_t = mu1 / m_total + rho * msgs.deg + p_t
        U_new = U_SOLVERS[cfg.u_solver](stats.G, M, rhs, c_t, precomp)

    # A update (eq. 21), purely local, on the fresh U
    eye = torch.eye(cfg.r, dtype=U.dtype, device=U.device)
    Ga = U_new.mT @ stats.G @ U_new + _bc(msgs.zeta + cfg.mu2) * eye
    A_new = torch.linalg.solve(Ga, U_new.mT @ stats.R + _bc(msgs.zeta) * A)
    return U_new, A_new


def dual_step(
    lam: torch.Tensor, resid_old: torch.Tensor, resid_new: torch.Tensor,
    cfg: ConsensusConfig,
):
    """Adaptive dual ascent on edge residuals (eq. 16 + the §IV gamma).

    resid_old/new are C U^k and C U^{k+1} per edge, (E, L, r).  Returns
    (lam_new, gamma (E,), primal_sq (E,))."""
    dual = torch.sum((resid_old - resid_new) ** 2, dim=(-2, -1))
    primal = torch.sum(resid_new**2, dim=(-2, -1))
    gamma = torch.clamp(cfg.delta * dual / torch.clamp(primal, min=1e-12),
                        max=cfg.gamma_cap)
    gamma = torch.clamp(gamma, min=cfg.gamma_floor)  # 0.0 = paper rule as-is
    gamma = torch.where(primal <= 1e-12,
                        torch.full_like(gamma, cfg.gamma_cap), gamma)
    return lam + cfg.rho * _bc(gamma) * resid_new, gamma, primal


def _resolve_tau_zeta(cfg: ConsensusConfig, deg: torch.Tensor, m: int, dtype):
    tau = torch.as_tensor(cfg.tau, dtype=dtype, device=deg.device)
    tau_t = tau + deg if tau.ndim == 0 else tau
    zeta_t = torch.as_tensor(cfg.zeta, dtype=dtype,
                             device=deg.device).expand(m)
    return tau_t, zeta_t


# --------------------------------------------------------------------------
# Robust neighbor aggregation (Byzantine resilience)
# --------------------------------------------------------------------------
#
# An aggregator replaces the plain mean of the views an agent received with
# a Byzantine-resilient center.  Signature: ``fn(V, M) -> center`` where
# ``V`` is ``(..., K, L, r)`` candidate views stacked on axis -3 and ``M``
# is a ``(..., K)`` {0, 1} validity mask (dropped / departed / padded
# candidates carry 0 and are EXCLUDED, never averaged in as zeros).  The
# executors always append the receiver's OWN current U as one candidate and
# rescale the center by the live degree, ``neigh_sum = deg_eff * center``,
# so ``agent_update`` is untouched.  ``"mean"`` maps to None: executors keep
# their segment-sum path.  All three robust rules are candidate-order
# invariant (a per-coordinate sort, or an order-free score).


def _sorted_candidates(V: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """(..., K, L, r) + mask -> per-coordinate ascending sort (..., L, r, K)
    with invalid candidates pushed to the top via a +huge sentinel."""
    Vk = torch.movedim(V, -3, -1)                      # (..., L, r, K)
    Mk = M[..., None, None, :]                         # (..., 1, 1, K)
    big = torch.finfo(V.dtype).max
    return torch.sort(torch.where(Mk > 0, Vk, big), dim=-1).values


def _agg_trimmed_mean(V: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise trimmed mean: drop the single smallest and largest
    VALID value per coordinate (only when >= 3 candidates are valid, else
    plain masked mean), average the rest."""
    Vs = _sorted_candidates(V, M)                      # (..., L, r, K)
    de = torch.sum(M, dim=-1)[..., None, None, None]   # (..., 1, 1, 1)
    b = (de >= 3.0).to(V.dtype)
    pos = torch.arange(V.shape[-3], dtype=V.dtype, device=V.device)
    w = (pos >= b) & (pos < de - b)                    # (..., 1, 1, K)
    kept = torch.where(w, Vs, 0.0)    # where, not a product: sentinel*0 = nan
    cnt = torch.clamp(de - 2.0 * b, min=1.0)
    return torch.sum(kept, dim=-1) / cnt[..., 0]


def _agg_coordinate_median(V: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Coordinate-wise median over the valid candidates (midpoint of the
    two central order statistics when the valid count is even)."""
    Vs = _sorted_candidates(V, M)                      # (..., L, r, K)
    n = torch.clamp(torch.sum(M, dim=-1).to(torch.int64), min=1)
    lo = ((n - 1) // 2)[..., None, None, None].expand(Vs.shape[:-1] + (1,))
    hi = (n // 2)[..., None, None, None].expand(lo.shape)
    vlo = torch.gather(Vs, -1, lo)[..., 0]
    vhi = torch.gather(Vs, -1, hi)[..., 0]
    return 0.5 * (vlo + vhi)


def _agg_krum_like(V: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Krum-flavored medoid: pick the single valid candidate minimizing the
    summed squared distance to all valid candidates (the first such on
    ties).  The center is one agent's ACTUAL subspace."""
    Vf = V.reshape(V.shape[:-2] + (-1,))               # (..., K, L*r)
    D = torch.sum((Vf[..., :, None, :] - Vf[..., None, :, :]) ** 2, dim=-1)
    score = torch.sum(M[..., None, :] * D, dim=-1)     # (..., K)
    big = torch.finfo(V.dtype).max
    idx = torch.argmin(torch.where(M > 0, score, big), dim=-1)
    idx_b = idx[..., None, None, None].expand(
        V.shape[:-3] + (1,) + V.shape[-2:])
    return torch.gather(V, -3, idx_b)[..., 0, :, :]


AGGREGATORS: dict[str, Callable | None] = {
    "mean": None,                # executors keep their plain-sum path
    "trimmed_mean": _agg_trimmed_mean,
    "coordinate_median": _agg_coordinate_median,
    "krum_like": _agg_krum_like,
}


def register_aggregator(name: str, fn: Callable) -> None:
    """Extension point: fn(V, M) -> center over the (..., K, L, r) candidate
    axis with a (..., K) {0, 1} validity mask (see AGGREGATORS notes)."""
    AGGREGATORS[name] = fn


def resolve_aggregator(cfg: ConsensusConfig) -> Callable | None:
    """cfg.aggregator -> the aggregation fn, or None for the plain mean."""
    if cfg.aggregator not in AGGREGATORS:
        raise ValueError(
            f"unknown aggregator {cfg.aggregator!r}; registered: "
            f"{sorted(AGGREGATORS)}"
        )
    return AGGREGATORS[cfg.aggregator]


# --------------------------------------------------------------------------
# The dense executor
# --------------------------------------------------------------------------


class _EdgeSetup(NamedTuple):
    """What the dense executor builds once: normalized stats, resolved
    proximal weights, the hoisted precomp, the exchange and the initial
    state."""

    stats: SufficientStats
    tau_t: torch.Tensor
    zeta_t: torch.Tensor
    precomp: object
    ex: exchange.DenseExchange
    init: "DenseState"


def _edge_setup(
    stats: SufficientStats, g: Graph, cfg: ConsensusConfig
) -> _EdgeSetup:
    m, L = stats.G.shape[0], stats.G.shape[-1]
    d = stats.R.shape[-1]
    dtype, device = stats.G.dtype, stats.G.device

    def per_agent(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device).expand(m)

    # scalar n/t2 get the agent axis every other leaf has
    stats = SufficientStats(G=stats.G, R=stats.R, n=per_agent(stats.n),
                            t2=per_agent(stats.t2))
    ex = exchange.DenseExchange(g, dtype, resolve_aggregator(cfg),
                                device=device)
    tau_t, zeta_t = _resolve_tau_zeta(cfg, ex.deg, m, dtype)
    init = DenseState(
        U=torch.ones((m, L, cfg.r), dtype=dtype, device=device),
        A=torch.ones((m, cfg.r, d), dtype=dtype, device=device),
        lam=torch.zeros((g.n_edges, L, cfg.r), dtype=dtype, device=device),
    )
    return _EdgeSetup(stats, tau_t, zeta_t, hoist_precomp(stats, cfg), ex,
                      init)


def _iteration_diag(stats, cfg, U, A, lam_new, resid_new, gamma,
                    primal) -> dict:
    """The per-iteration diagnostics (0-d tensors):

      objective   primal objective (eq. 12), from stats alone
      lagrangian  augmented Lagrangian (eq. 13)
      consensus   RMS edge disagreement sqrt(mean (C U)^2)
      gamma       mean adaptive dual step over edges
      gamma_min   min over edges
      primal_sq   sum of squared edge residuals

    and, with ``cfg.telemetry``, ``resid_max`` (max |C U|); the message
    counters are constant for a runner and filled in by :func:`_diag_rows`.
    """
    obj = objective_from_stats(stats, U, A, cfg.mu1, cfg.mu2)
    diag = {
        "objective": obj,
        "lagrangian": obj
        + torch.sum(lam_new * resid_new)
        + 0.5 * cfg.rho * torch.sum(resid_new**2),
        "consensus": torch.sqrt(torch.mean(resid_new**2)),
        "gamma": torch.mean(gamma),
        "gamma_min": torch.min(gamma),
        "primal_sq": torch.sum(primal),
    }
    if cfg.telemetry:
        diag["resid_max"] = torch.max(torch.abs(resid_new))
    return diag


DIAG_KEYS = ("objective", "lagrangian", "consensus", "gamma", "gamma_min",
             "primal_sq")
TELEMETRY_KEYS = ("resid_max", "msgs_delivered", "msgs_stale",
                  "msgs_dropped", "agg_rejected")


class RunState(NamedTuple):
    """The mid-run state the single-device executors advance, in the
    reference's field order (``None`` leaves are not saved).

      dense     hist = lam_hist = None
      colored   hist (s, m, L, r) with staleness s: hist[j] = U published
                at the end of iteration k - s + j (U^0 before the start)
      async     hist (depth, m, L, r), the published-U ring buffer: slot
                ``j % depth`` holds the U published at the end of tick j
                (U^0 before); lam_hist (depth, E, L, r), the duals' ring,
                iff aged_duals; ``k`` is the tape cursor
      sharded   agents leading on every leaf, the gathered state of all
                ranks (the layouts are listed at the sharded executors)
    """

    U: torch.Tensor     # (m, L, r) stacked subspaces
    A: torch.Tensor     # (m, r, d) stacked heads
    lam: torch.Tensor   # (E, L, r) per-edge duals
    k: int              # iterations done (the absolute tick)
    hist: torch.Tensor | None = None
    lam_hist: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class Runner:
    """A segmented executor: ``init_state()`` + ``run_segment(state, n)``.
    Splitting ``cfg.iters`` into segments runs the same sequence of
    updates as one uninterrupted run."""

    executor: str
    cfg: ConsensusConfig
    init_fn: Callable[[], RunState]
    segment_fn: Callable[[RunState, int], tuple[RunState, dict]]
    # the sharded executors' mesh: every rank holds the gathered state, and
    # rank 0 alone writes checkpoints (repro_torch.checkpoint)
    mesh: object = None

    def init_state(self) -> RunState:
        """The k=0 state (all-ones U/A, zero duals)."""
        return self.init_fn()

    def run_segment(self, state: RunState, n_iters: int):
        """Advance ``n_iters`` iterations: ``(state, diags)`` with one
        diagnostics row per iteration of THIS segment."""
        n = int(n_iters)
        if n < 0:
            raise ValueError(f"n_iters must be >= 0, got {n_iters}")
        if state.k + n > self.cfg.iters:
            raise ValueError(
                f"segment [{state.k}, {state.k + n}) runs past cfg.iters="
                f"{self.cfg.iters}"
            )
        tr = obs_trace.current()
        if tr is None:
            return self.segment_fn(state, n)
        with tr.span("segment", executor=self.executor, start=state.k,
                     iters=n):
            out = self.segment_fn(state, n)
            obs_trace.block_until_ready(out)
        return out

    def run(self, state: RunState | None = None):
        """Drive to ``cfg.iters`` from ``state`` (or a fresh init_state)."""
        if state is None:
            state = self.init_state()
        if state.k > self.cfg.iters:
            raise ValueError(
                f"state is at iteration {state.k}, past cfg.iters="
                f"{self.cfg.iters}"
            )
        return self.run_segment(state, self.cfg.iters - state.k)


def _stack_rows(rows: list, keys, like: torch.Tensor) -> dict:
    """Stack per-iteration diagnostics rows into (n,) tensors."""
    return {
        key: (torch.stack([r[key] for r in rows]) if rows
              else torch.zeros((0,), dtype=like.dtype, device=like.device))
        for key in keys
    }


def _diag_rows(rows: list, like: torch.Tensor, cfg: ConsensusConfig,
               comm_floats: int, n_edges: int, fresh: float) -> dict:
    """Stack per-iteration diagnostics rows into (n,) tensors; with
    ``cfg.telemetry`` also ``resid_max`` and the counters of the runner:
    ``fresh`` of the 2·E neighbor deliveries arrive fresh, the rest stale,
    none is dropped, and ``comm_floats`` floats move.  ``agg_rejected`` is
    the rows' own audit on the robust path, and 0 on the mean path."""
    keys = DIAG_KEYS + (("resid_max",) if cfg.telemetry else ())
    diags = _stack_rows(rows, keys, like)
    if cfg.telemetry:
        for key, value in (("msgs_delivered", fresh),
                           ("msgs_stale", 2.0 * n_edges - fresh),
                           ("msgs_dropped", 0.0), ("agg_rejected", 0.0),
                           ("comm_floats", comm_floats)):
            diags[key] = torch.full((len(rows),), float(value),
                                    dtype=like.dtype, device=like.device)
        if rows and "agg_rejected" in rows[0]:
            diags["agg_rejected"] = torch.stack(
                [r["agg_rejected"] for r in rows])
    return diags


def make_runner(
    stats: SufficientStats, g: Graph | None = None,
    cfg: ConsensusConfig | None = None, *,
    executor: str = "dense",
    mesh=None, agent_axes: Sequence[str] | None = None,
    schedule: Sequence[Sequence[int]] | None = None,
    staleness: int = 0, order: str = "fixed",
    tape=None, aged_duals: bool = False,
) -> Runner:
    """The segmented :class:`Runner` of any executor:

      executor="dense"          (stats, g, cfg), behind :func:`fit_dense`
      executor="colored"        + schedule/staleness/order (:func:`fit_colored`)
      executor="async"          + tape (aged_duals optional) (:func:`fit_async`)
      executor="sharded"        (stats, cfg) + mesh/agent_axes
                                (:func:`fit_sharded`)
      executor="sharded_graph"  + g, and a vertex schedule or a tape
                                (:func:`fit_sharded_graph`)

    ``tape=`` on ``executor="sharded"`` goes to the graph executor (the
    ring/torus fast path replays no tape) and so needs ``g``, the graph
    whose edge order the tape was sampled on.  ``runner.run()`` reproduces
    the ``fit_*`` call; ``runner.run(state)`` starts from a given
    :class:`RunState`."""
    if cfg is None:
        raise ValueError("make_runner requires a ConsensusConfig")
    executors = ("dense", "colored", "async", "sharded", "sharded_graph")
    if executor not in executors:
        raise ValueError(
            f"unknown executor {executor!r}; expected one of 'dense', "
            f"'colored', 'async', 'sharded', 'sharded_graph'"
        )
    sharded = executor in ("sharded", "sharded_graph")
    if not sharded and (mesh is not None or agent_axes is not None):
        raise ValueError("mesh=/agent_axes= only apply to executor='sharded' "
                         "or 'sharded_graph'")
    if executor not in ("async", "sharded", "sharded_graph") and (
            tape is not None or aged_duals):
        raise ValueError("tape=/aged_duals= only apply to executor='async' "
                         "or the sharded executors")
    if executor not in ("colored", "sharded", "sharded_graph") and (
            schedule is not None):
        raise ValueError("schedule= only applies to executor='colored' or "
                         "the sharded executors")
    if executor != "colored" and (staleness != 0 or order != "fixed"):
        raise ValueError(
            "staleness=/order= only apply to executor='colored'"
        )
    if sharded:
        if mesh is None or agent_axes is None:
            raise ValueError(f"executor={executor!r} needs mesh= and "
                             f"agent_axes=")
        if executor == "sharded" and tape is None and not aged_duals \
                and schedule is None:
            return _make_sharded_runner(stats, mesh, agent_axes, cfg)
        if g is None:
            raise ValueError(
                "the graph-compiled sharded executor needs g=: the Graph "
                "to compile (and, with tape=, whose edge order the tape was "
                "sampled on)")
        return _make_sharded_graph_runner(
            stats, mesh, agent_axes, g, cfg, schedule=schedule, tape=tape,
            aged_duals=aged_duals)
    if executor == "colored":
        return _colored_runner(stats, g, cfg, schedule=schedule,
                               staleness=staleness, order=order)
    if executor == "async":
        # imported here, as the reference does: netsim imports the engine
        from repro_torch.netsim.executor import make_async_runner

        return make_async_runner(stats, g, cfg, tape, aged_duals=aged_duals)
    es = _edge_setup(stats, g, cfg)
    stats = es.stats
    m = stats.G.shape[0]
    comm = modeled_floats_per_iter("dense", L=stats.G.shape[-1], r=cfg.r,
                                   n_edges=g.n_edges)

    def step(U, A, lam):
        views = es.ex.gather_views(U, lam)
        msgs = NeighborMsgs(views.neigh, views.ct_lam, views.deg_eff,
                            es.tau_t, es.zeta_t)
        U_new, A_new = agent_update(stats, AgentState(U, A), msgs, cfg,
                                    m_total=m, precomp=es.precomp)
        # the solvers may return column-major layouts, and a BLAS call's
        # last bits can follow the layout: the state is made contiguous, the
        # layout a restored checkpoint has, before anything reads it, so a
        # resumed run (and the async executor on a zero-delay tape) repeats
        # this one bit for bit
        U_new, A_new = U_new.contiguous(), A_new.contiguous()
        resid_old = es.ex.edge_diff(U)
        resid_new = es.ex.edge_diff(U_new)
        lam_new, gamma, primal = dual_step(lam, resid_old, resid_new, cfg)
        diag = _iteration_diag(stats, cfg, U_new, A_new, lam_new, resid_new,
                               gamma, primal)
        if cfg.telemetry and es.ex.agg is not None:
            diag["agg_rejected"] = es.ex.audit(U)
        return U_new, A_new, lam_new, diag

    def init_fn():
        return RunState(U=es.init.U, A=es.init.A, lam=es.init.lam, k=0)

    def segment_fn(state, n):
        U, A, lam = state.U, state.A, state.lam
        rows = []
        for _ in range(n):
            U, A, lam, diag = step(U, A, lam)
            rows.append(diag)
        # synchronous Jacobian delivery: both ends of every edge receive the
        # fresh U each iteration
        return (RunState(U=U, A=A, lam=lam, k=state.k + n),
                _diag_rows(rows, U, cfg, comm, g.n_edges, 2.0 * g.n_edges))

    return Runner("dense", cfg, init_fn, segment_fn)


class DenseState(NamedTuple):
    """Stacked executor state: all agents on the leading axis."""

    U: torch.Tensor    # (m, L, r)
    A: torch.Tensor    # (m, r, d)
    lam: torch.Tensor  # (E, L, r)


def fit_dense(
    stats: SufficientStats, g: Graph, cfg: ConsensusConfig,
) -> tuple[DenseState, dict]:
    """Run Algorithm 2 (or 3 if cfg.first_order) over stats on graph ``g``.

    Returns the final stacked state and per-iteration diagnostics
    (``objective``, ``lagrangian``, ``consensus``, ``gamma``,
    ``gamma_min``, ``primal_sq``; each a (cfg.iters,) tensor), all computed
    from stats alone."""
    state, diags = make_runner(stats, g, cfg).run()
    return DenseState(state.U, state.A, state.lam), diags


# --------------------------------------------------------------------------
# The colored executor: Gauss-Seidel sweeps over color classes
# --------------------------------------------------------------------------


def jacobian_schedule(m: int) -> tuple[tuple[int, ...], ...]:
    """The single-class schedule: every agent in one class.  Running
    :func:`fit_colored` with it reproduces the Jacobian sweep of
    :func:`fit_dense`."""
    return (tuple(range(m)),)


def _validate_schedule(schedule, m: int) -> None:
    seen: set[int] = set()
    for cls in schedule:
        for t in cls:
            if not 0 <= t < m:
                raise ValueError(f"schedule agent {t} out of range for m={m}")
            if t in seen:
                raise ValueError(f"agent {t} appears twice in schedule")
            seen.add(t)
    if len(seen) != m:
        raise ValueError(
            f"schedule covers {len(seen)} of {m} agents; classes must "
            f"partition the agent set"
        )


def fit_colored(
    stats: SufficientStats,
    g: Graph,
    cfg: ConsensusConfig,
    *,
    schedule: Sequence[Sequence[int]] | None = None,
    staleness: int = 0,
    order: str = "fixed",
) -> tuple[DenseState, dict]:
    """Gauss-Seidel / colored-sweep executor around the same
    :func:`agent_update`.

    The agents update one color class at a time (``schedule`` defaults to
    :meth:`Graph.chromatic_schedule`), with ``neigh_sum`` re-gathered from
    the live U between classes, so later classes see the current iterate
    of earlier ones.  One ADMM iteration is all classes plus one shared
    :func:`dual_step`.

    ``staleness=k >= 1`` makes every class of iteration i gather from the
    U published at the end of iteration i - k (U^0 while i < k);
    ``staleness=1`` is the Jacobian sweep of :func:`fit_dense` for any
    schedule.  ``order="gauss_southwell"`` (needs ``staleness=0``) runs the
    classes each iteration in order of the summed squared residual of
    their incident edges, largest first; ties keep schedule order.

    The adaptive gamma can collapse before consensus under these faster
    sweeps: ``cfg.gamma_floor`` (e.g. 0.05) keeps the duals moving.
    Returns ``(DenseState, diagnostics)`` like :func:`fit_dense`."""
    runner = _colored_runner(stats, g, cfg, schedule=schedule,
                             staleness=staleness, order=order)
    state, diags = runner.run()
    return DenseState(state.U, state.A, state.lam), diags


def fit_async(
    stats: SufficientStats, g: Graph, cfg: ConsensusConfig, tape, *,
    aged_duals: bool = False,
) -> tuple[DenseState, dict]:
    """The ``repro_torch.netsim`` event-tape executor: the same
    :func:`agent_update` under simulated asynchrony (per-edge delays,
    dropped messages, stragglers, and with an ``AdversaryTape`` Byzantine
    senders and membership churn).  ``netsim.zero_delay_tape`` gives
    :func:`fit_dense` bit for bit, ``netsim.constant_tape(k)``
    ``fit_colored(staleness=k, schedule=jacobian_schedule(m))``.  See
    ``repro_torch.netsim.executor`` (imported here, so the engine does not
    import netsim at load time)."""
    from repro_torch.netsim.executor import fit_async as _fit_async

    return _fit_async(stats, g, cfg, tape, aged_duals=aged_duals)


class _Phase(NamedTuple):
    """What one color class needs, sliced once outside the loop."""

    idx: torch.Tensor          # (k,) agents of the class
    stats: SufficientStats     # the class's rows
    precomp: object
    deg: torch.Tensor
    tau: torch.Tensor
    zeta: torch.Tensor


def _make_phase(cls, es: _EdgeSetup) -> _Phase:
    idx = torch.as_tensor(cls, dtype=torch.int64, device=es.stats.G.device)
    st = es.stats
    stats_c = SufficientStats(G=st.G[idx], R=st.R[idx], n=st.n[idx],
                              t2=st.t2[idx])
    precomp_c = (None if es.precomp is None
                 else tuple(x[idx] for x in es.precomp))
    return _Phase(idx, stats_c, precomp_c, es.ex.deg[idx], es.tau_t[idx],
                  es.zeta_t[idx])


def _colored_runner(
    stats: SufficientStats, g: Graph, cfg: ConsensusConfig, *,
    schedule=None, staleness: int = 0, order: str = "fixed",
) -> Runner:
    """Validate the colored-sweep arguments and build its Runner."""
    if staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    if order not in ("fixed", "gauss_southwell"):
        raise ValueError(
            f"unknown order {order!r}; expected 'fixed' or 'gauss_southwell'"
        )
    if schedule is None:
        schedule = g.chromatic_schedule()
    schedule = tuple(tuple(int(t) for t in cls) for cls in schedule)
    _validate_schedule(schedule, stats.G.shape[0])
    if order == "gauss_southwell" and staleness != 0:
        raise ValueError(
            "order='gauss_southwell' requires staleness=0: with frozen "
            "k-round-old views every phase reads the same snapshot, so "
            "the class order cannot affect the sweep"
        )
    es = _edge_setup(stats, g, cfg)
    stats = es.stats
    m = stats.G.shape[0]
    phases = [_make_phase(cls, es) for cls in schedule]
    # class-edge incidence for the Gauss-Southwell scores: a proper coloring
    # puts the two ends of an edge in two classes, so each edge scores both
    cls_of = {t: p for p, cls in enumerate(schedule) for t in cls}
    inc = torch.zeros((len(schedule), g.n_edges), dtype=stats.G.dtype,
                      device=stats.G.device)
    for j, (s, e) in enumerate(g.edges):
        inc[cls_of[s], j] = 1.0
        inc[cls_of[e], j] = 1.0
    comm = modeled_floats_per_iter("colored", L=stats.G.shape[-1], r=cfg.r,
                                   n_edges=g.n_edges)
    # staleness <= 1 reads current-round views (the live U or the previous
    # iterate), which count as fresh; deeper staleness serves every message
    # stale
    fresh = 2.0 * g.n_edges if staleness <= 1 else 0.0

    def sweep_order(U):
        if order == "fixed":
            return range(len(phases))
        edge_sq = torch.sum(es.ex.edge_diff(U) ** 2, dim=(-2, -1))   # (E,)
        # stable: ties (iteration 0's zero residuals) keep schedule order
        return torch.argsort(-(inc @ edge_sq), stable=True).tolist()

    def step(U, A, lam, hist):
        U_start = U
        # lam moves only at iteration end, so C^T lam is gathered once; the
        # neighbor view is the live U (staleness 0, regathered per class)
        # or the frozen snapshot from `staleness` iterations back
        ct_lam = es.ex.ct_transpose(lam)
        for p in sweep_order(U):
            ph = phases[p]
            view = U if staleness == 0 else hist[0]
            msgs = NeighborMsgs(es.ex.neighbor_sum(view)[ph.idx],
                                ct_lam[ph.idx], ph.deg, ph.tau, ph.zeta)
            U_c, A_c = agent_update(ph.stats, AgentState(U[ph.idx], A[ph.idx]),
                                    msgs, cfg, m_total=m, precomp=ph.precomp)
            U = U.index_copy(0, ph.idx, U_c)
            A = A.index_copy(0, ph.idx, A_c)
        resid_old = es.ex.edge_diff(U_start)
        resid_new = es.ex.edge_diff(U)
        lam_new, gamma, primal = dual_step(lam, resid_old, resid_new, cfg)
        diag = _iteration_diag(stats, cfg, U, A, lam_new, resid_new, gamma,
                               primal)
        if cfg.telemetry and es.ex.agg is not None:
            diag["agg_rejected"] = es.ex.audit(
                U_start if staleness == 0 else hist[0])
        if staleness > 0:
            hist = torch.cat([hist[1:], U[None]], dim=0)
        return U, A, lam_new, hist, diag

    def init_fn():
        # the Gauss-Southwell state carries no window, as the reference's
        U0 = es.init.U
        hist = (None if order == "gauss_southwell"
                else U0.expand((staleness,) + tuple(U0.shape)))
        return RunState(U=U0, A=es.init.A, lam=es.init.lam, k=0, hist=hist)

    def segment_fn(state, n):
        U, A, lam, hist = state.U, state.A, state.lam, state.hist
        rows = []
        for _ in range(n):
            U, A, lam, hist, diag = step(U, A, lam, hist)
            rows.append(diag)
        return (RunState(U=U, A=A, lam=lam, k=state.k + n, hist=hist),
                _diag_rows(rows, U, cfg, comm, g.n_edges, fresh))

    return Runner("colored", cfg, init_fn, segment_fn)


# --------------------------------------------------------------------------
# The sharded executors: one agent per rank (repro_torch.core.mesh)
# --------------------------------------------------------------------------
#
# Every rank runs the same program, as every shard runs the reference's
# shard_map body: it reduces only its own agent's statistics, trades U and
# the edge duals with its neighbors by ppermute, and runs the shared
# agent_update on a batch of one agent.  Between segments every rank holds
# the whole state in the reference's layout, gathered in agent order (so a
# checkpoint is the reference's), and a segment starts from its own row:
#
#   sharded         lam (m, n_axes, L, r): the dual of agent t's edge to
#                   its +1 neighbor along each axis
#   sharded_graph   lam (m, n_slots, L, r): the duals of the edges agent t
#                   is the source of (EdgeSchedule slots); with a tape, hist
#                   (m, depth, L, r), each agent's OWN published U (slot
#                   k % depth the U of the end of tick k), and with
#                   aged_duals lam_hist (m, depth, n_slots, L, r)
#
# The per-agent diagnostics columns are gathered at a segment's end and
# summed over agents in agent order on every rank, so every rank returns
# the same diagnostics.


def torus_edges(sizes: Sequence[int]) -> set:
    """Directed edge set of the ring/torus :func:`fit_sharded` realizes:
    agents are the row-major flattening of the agent-axis grid, and along
    each axis every coordinate owns the edge to its +1 neighbor (a size-2
    axis is the degenerate ring with a SINGLE edge)."""
    import itertools

    sizes = list(sizes)
    strides = [1] * len(sizes)
    for i in range(len(sizes) - 2, -1, -1):
        strides[i] = strides[i + 1] * sizes[i + 1]

    def flat(coord):
        return sum(c * s for c, s in zip(coord, strides))

    edges = set()
    for ax_i, n_ax in enumerate(sizes):
        for coord in itertools.product(*(range(s) for s in sizes)):
            if n_ax == 2 and coord[ax_i] == 1:
                continue
            nb = list(coord)
            nb[ax_i] = (coord[ax_i] + 1) % n_ax
            edges.add((flat(coord), flat(nb)))
    return edges


def graph_matches_torus(g: Graph, sizes: Sequence[int]) -> bool:
    """True iff ``g`` is the mesh ring/torus up to per-edge orientation
    (flipping an edge flips its dual's sign and nothing else).  Compares
    undirected edge sets; a duplicated edge fails the match."""
    und = {frozenset(e) for e in g.edges}
    if len(und) != len(g.edges):
        return False
    return und == {frozenset(e) for e in torus_edges(sizes)}


def _local_objective(stats_t: SufficientStats, U, A, cfg: ConsensusConfig,
                     m_total: int) -> torch.Tensor:
    """ONE agent's share of the primal objective (eq. 12) from its own
    stats (a batch of one agent, ``n``/``t2`` included); summed over agents
    it is :func:`objective_from_stats`."""
    UtGU = U.mT @ (stats_t.G @ U)
    quad = torch.sum((UtGU @ A) * A)                 # tr(A^T U^T G U A)
    cross = torch.sum((U.mT @ stats_t.R) * A)        # tr(A^T U^T R)
    t2 = torch.sum(torch.as_tensor(stats_t.t2, dtype=torch.float32,
                                   device=U.device))
    return (0.5 * (quad - 2.0 * cross + t2)
            + 0.5 * (cfg.mu1 / m_total) * torch.sum(U**2)
            + 0.5 * cfg.mu2 * torch.sum(A**2))


def _agent_sum(cols: torch.Tensor) -> torch.Tensor:
    """(iters, m) -> (iters,), added agent by agent in agent order."""
    out = cols[:, 0]
    for t in range(1, cols.shape[1]):
        out = out + cols[:, t]
    return out


def _assemble_sharded_diags(diags: dict, n_edges: int, lr_size: int) -> dict:
    """The per-agent (iters, m) diagnostics columns -> the shared executor
    diagnostics.  Each agent reports only the edges it owns, so the sums
    over agents count every edge once."""
    obj = _agent_sum(diags["obj"])
    primal = _agent_sum(diags["primal_sq"])
    out = {
        "objective": obj,
        "lagrangian": obj + _agent_sum(diags["lag_pen"]),
        "consensus": torch.sqrt(primal / (n_edges * lr_size)),
        "gamma": _agent_sum(diags["gamma_sum"]) / n_edges,
        "gamma_min": torch.amin(diags["gamma_min"], dim=1),
        "primal_sq": primal,
    }
    # telemetry: counts sum over agents, the worst residual is their max
    if "resid_max" in diags:
        out["resid_max"] = torch.amax(diags["resid_max"], dim=1)
    for key in ("agg_rejected", "msgs_delivered", "msgs_stale",
                "msgs_dropped"):
        if key in diags:
            out[key] = _agent_sum(diags[key])
    return out


_SHARD_KEYS = ("obj", "lag_pen", "primal_sq", "gamma_sum", "gamma_min")
_SHARD_TELEMETRY_KEYS = ("resid_max", "agg_rejected", "msgs_delivered",
                         "msgs_stale", "msgs_dropped")


def _gather_columns(mesh, rows: list, cfg: ConsensusConfig,
                    like: torch.Tensor) -> dict:
    """This rank's per-iteration 0-d diagnostics -> every agent's (iters, m)
    columns, on every rank."""
    keys = _SHARD_KEYS + (_SHARD_TELEMETRY_KEYS if cfg.telemetry else ())
    local = (torch.stack([torch.stack([r[k] for k in keys]) for r in rows])
             if rows else like.new_zeros((0, len(keys))))
    every = mesh.all_gather(local)                  # (m, iters, keys)
    return {k: every[:, :, i].mT for i, k in enumerate(keys)}


class ShardState(NamedTuple):
    """One agent's state inside a sharded segment."""

    U: torch.Tensor     # (L, r)
    A: torch.Tensor     # (r, d)
    lam: torch.Tensor   # (n_axes | n_slots, L, r) the duals it owns


def own_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's agent's rows of a per-agent input: row ``rank`` of the
    global stack (m, ...), or the rank's own (1, ...) block as it is."""
    m, rows = mesh.size, x.shape[0]
    if rows == m:
        return x[mesh.rank:mesh.rank + 1]
    if rows == 1:
        return x
    raise ValueError(f"m={rows} must equal prod(agent axes)={m} (or 1: "
                     f"this rank's own block)")


def _shard_stats(stats: SufficientStats, mesh) -> SufficientStats:
    """This rank's agent's statistics as a batch of one agent, on the
    mesh's device.  ``stats`` is the global stack
    (m, ...), of which the rank takes its row, or the rank's own (1, ...)
    block; scalar ``n``/``t2`` apply to every agent."""
    m, t = mesh.size, mesh.rank
    rows = stats.G.shape[0]
    device = mesh.device

    def own(x):
        return own_rows(x, mesh).to(device).contiguous()

    def leaf(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        if x.ndim == 0:
            return x.reshape(1)
        return x[t:t + 1] if x.shape[0] == m and rows == m else x.reshape(1)

    return SufficientStats(G=own(stats.G), R=own(stats.R), n=leaf(stats.n),
                           t2=leaf(stats.t2))


def _shard_tau_zeta(cfg: ConsensusConfig, deg: torch.Tensor, t: int):
    """This agent's (tau_t, zeta_t), (1,) each, resolved as
    :func:`_resolve_tau_zeta` resolves every agent's."""
    tau = torch.as_tensor(cfg.tau, dtype=deg.dtype, device=deg.device)
    tau_t = tau + deg if tau.ndim == 0 else tau.reshape(-1)[t:t + 1]
    zeta_t = torch.as_tensor(cfg.zeta, dtype=deg.dtype,
                             device=deg.device).expand(1)
    return tau_t, zeta_t


def _update_one(stats_t, U, A, neigh, ct_lam, deg, tau, zeta, cfg, m_total,
                precomp):
    """:func:`agent_update` on this rank's agent (a batch of one): the new
    (U, A), contiguous, the layout a restored checkpoint has."""
    msgs = NeighborMsgs(neigh[None], ct_lam[None], deg, tau, zeta)
    U_new, A_new = agent_update(stats_t, AgentState(U[None], A[None]), msgs,
                                cfg, m_total=m_total, precomp=precomp)
    return U_new[0].contiguous(), A_new[0].contiguous()


def _ring_sizes(mesh, axes) -> list[int]:
    """The agent axes' sizes; a ring needs two agents or more."""
    sizes = [mesh.shape[ax] for ax in axes]
    for ax, n_ax in zip(axes, sizes):
        if n_ax < 2:
            raise ValueError(f"agent axis {ax!r} needs >= 2 shards, got "
                             f"{n_ax}")
    return sizes


def ring_iteration(
    state: ShardState,
    stats: SufficientStats,
    mesh,
    agent_axes: Sequence[str],
    cfg: ConsensusConfig,
    m_total: int,
    precomp=None,
) -> tuple[ShardState, dict]:
    """One ADMM round of this rank's agent on the mesh ring/torus.

    Message plumbing around :func:`agent_update`: gather the neighbors'
    subspaces and the incoming edge duals over each axis' ring, run the
    shared body, ship the fresh U once more for the edge-dual step: 3
    ppermutes of U and 1 of lambda per agent axis.  A size-2 axis is the
    degenerate ring with one edge (0, 1): degree 1 along it, the one
    neighbor counted once, and only agent 0 owns the dual.  ``stats`` is
    this agent's batch of one; the diagnostics count owned edges only."""
    U, A, lam = state
    axes = tuple(agent_axes)
    sizes = _ring_sizes(mesh, axes)
    coords = mesh.coords(mesh.rank)
    dtype, device = U.dtype, U.device
    deg = torch.tensor(sum(1.0 if n_ax == 2 else 2.0 for n_ax in sizes),
                       dtype=dtype, device=device)
    tau_t, zeta_t = _shard_tau_zeta(cfg, deg.reshape(1), mesh.rank)

    # --- gather neighbor subspaces and incoming edge duals --------------
    robust_agg = resolve_aggregator(cfg)
    neigh = torch.zeros_like(U)
    ct_lam = torch.zeros_like(U)
    views, u_next_old, own_edge = [], [], []
    for i, n_ax in enumerate(sizes):
        u_next = mesh.ppermute(U, mesh.axis_shift(i, -1))        # U_{t+1}
        lam_prev = mesh.ppermute(lam[i], mesh.axis_shift(i, 1))  # (t-1, t)
        if n_ax == 2:
            # one edge: the one neighbor arrives on both permutes; count it
            # once, and only agent 0 owns the edge's dual
            neigh = neigh + u_next
            views.append(u_next)
            own = coords[i] == 0
        else:
            u_prev = mesh.ppermute(U, mesh.axis_shift(i, 1))     # U_{t-1}
            neigh = neigh + u_next + u_prev
            views.extend((u_next, u_prev))
            own = True
        # C_t^T lambda: +lam on the own (source) edge, -lam on the incoming
        ct_lam = ct_lam + lam[i] - lam_prev
        u_next_old.append(u_next)
        own_edge.append(own)
    if robust_agg is not None:
        neigh = exchange.stack_ring_candidates(views, U, deg, robust_agg)
    agg_rejected = torch.zeros((), dtype=dtype, device=device)
    if cfg.telemetry and robust_agg is not None:
        # neigh = deg * agg(V, Mv): neigh / deg is the center audited
        V = torch.stack(views + [U])
        Mv = torch.ones((V.shape[0],), dtype=dtype, device=device)
        agg_rejected = torch.sum(exchange.aggregator_audit(V, Mv,
                                                           neigh / deg))

    # --- the shared per-agent body ---------------------------------------
    U_new, A_new = _update_one(stats, U, A, neigh, ct_lam, deg.reshape(1),
                               tau_t, zeta_t, cfg, m_total, precomp)

    # --- dual step on the owned edge (t, t+1) of each axis ----------------
    lam_new = []
    zero = torch.zeros((), dtype=dtype, device=device)
    primal_sq = gamma_sum = lag_pen = resid_max = zero
    gamma_min = torch.full((), torch.inf, dtype=dtype, device=device)
    for i in range(len(axes)):
        u_next_new = mesh.ppermute(U_new, mesh.axis_shift(i, -1))
        if not own_edge[i]:
            lam_new.append(torch.zeros_like(lam[i]))
            continue
        resid_new = U_new - u_next_new                   # C_i U^{k+1}
        resid_old = U - u_next_old[i]                    # C_i U^k
        lam_ax, gamma, primal = dual_step(lam[i], resid_old, resid_new, cfg)
        lam_new.append(lam_ax)
        primal_sq = primal_sq + primal
        gamma_sum = gamma_sum + gamma
        gamma_min = torch.minimum(gamma_min, gamma)
        lag_pen = lag_pen + (torch.sum(lam_ax * resid_new)
                             + 0.5 * cfg.rho * torch.sum(resid_new**2))
        if cfg.telemetry:
            resid_max = torch.maximum(resid_max,
                                      torch.max(torch.abs(resid_new)))
    diag = {"primal_sq": primal_sq, "gamma_sum": gamma_sum,
            "gamma_min": gamma_min, "lag_pen": lag_pen}
    if cfg.telemetry:
        # every ring view arrives fresh each iteration: deg deliveries per
        # agent, nothing stale or dropped
        diag.update(resid_max=resid_max, agg_rejected=agg_rejected,
                    msgs_delivered=deg, msgs_stale=zero, msgs_dropped=zero)
    return ShardState(U_new, A_new, torch.stack(lam_new)), diag


def _gathered(mesh, **leaves) -> dict:
    """Every rank's row of each leaf, stacked in agent order."""
    return {k: (None if v is None else mesh.all_gather(v))
            for k, v in leaves.items()}


def _make_sharded_runner(stats: SufficientStats, mesh,
                         agent_axes: Sequence[str],
                         cfg: ConsensusConfig) -> Runner:
    """Runner of :func:`fit_sharded`: the ring/torus of the agent axes."""
    axes = mesh.check_agent_axes(agent_axes)
    sizes = _ring_sizes(mesh, axes)
    m, t = mesh.size, mesh.rank
    st = _shard_stats(stats, mesh)
    L, d, r = st.G.shape[-1], st.R.shape[-1], cfg.r
    dtype, device = st.G.dtype, st.G.device
    n_axes = len(axes)
    n_edges = len(torus_edges(sizes))
    precomp = hoist_precomp(st, cfg)      # eigh of this agent's G, once
    comm = modeled_floats_per_iter("sharded", L=L, r=r, m=m, n_axes=n_axes)

    def init_fn():
        return RunState(
            U=torch.ones((m, L, r), dtype=dtype, device=device),
            A=torch.ones((m, r, d), dtype=dtype, device=device),
            lam=torch.zeros((m, n_axes, L, r), dtype=dtype, device=device),
            k=0)

    def segment_fn(state, n):
        cur = ShardState(state.U[t].to(device), state.A[t].to(device),
                         state.lam[t].to(device))
        rows = []
        for _ in range(n):
            cur, diag = ring_iteration(cur, st, mesh, axes, cfg, m, precomp)
            diag["obj"] = _local_objective(st, cur.U[None], cur.A[None], cfg,
                                           m)
            rows.append(diag)
        diags = _assemble_sharded_diags(_gather_columns(mesh, rows, cfg,
                                                        cur.U),
                                        n_edges, L * r)
        if cfg.telemetry:
            diags["comm_floats"] = torch.full((n,), float(comm), dtype=dtype,
                                              device=device)
        return RunState(k=state.k + n,
                        **_gathered(mesh, U=cur.U, A=cur.A, lam=cur.lam)), \
            diags

    return Runner("sharded", cfg, init_fn, segment_fn, mesh=mesh)


def fit_sharded(stats: SufficientStats, mesh, agent_axes: Sequence[str],
                cfg: ConsensusConfig):
    """Consensus ADMM with one agent per rank of ``mesh``: the graph is the
    ring/torus of the agent axes (:func:`torus_edges`), and each rank runs
    the same :func:`agent_update` as :func:`fit_dense` on its own agent.
    ``stats`` is the global stack (m, ...) or the rank's own (1, ...) block;
    only U_t and the edge duals cross ranks.  Every rank calls it and gets
    (U (m, L, r), A (m, r, d), diagnostics), gathered in agent order, with
    the shared diagnostics keys."""
    state, diags = _make_sharded_runner(stats, mesh, agent_axes, cfg).run()
    return state.U, state.A, diags


def _make_sharded_graph_runner(
    stats: SufficientStats, mesh, agent_axes: Sequence[str], g: Graph,
    cfg: ConsensusConfig, *,
    schedule: Sequence[Sequence[int]] | None = None,
    tape=None, aged_duals: bool = False,
) -> Runner:
    """Runner of :func:`fit_sharded_graph`: consensus ADMM over ANY
    connected graph, one agent per rank.

    ``compile_edge_schedule`` splits ``g``'s edges into <= Δ+1 matchings;
    each is one bidirectional ppermute round (idle ranks receive zeros).
    The round sums give ``fit_dense``'s neighbor sums, C^T lambda and dual
    steps: the dual of edge (s, e) lives on rank s (the schedule's slot
    table), as the dense executor keeps it with the source.

    ``schedule`` (a vertex-class partition, e.g. ``g.chromatic_schedule()``)
    runs Gauss-Seidel phases: each phase re-exchanges the live U and
    updates its class, so later classes see earlier classes' fresh
    subspaces, as :func:`fit_colored` with ``staleness=0``.
    ``schedule=None`` is the Jacobian sweep (``fit_dense``).  Per iteration:
    ``rounds * (phases + 1)`` U-ppermutes and ``rounds`` dual-ppermutes.

    ``tape=`` replays an ``EventTape``/``AdversaryTape`` in the mesh
    (Jacobian sweep only): each rank keeps a ring buffer of its OWN
    published U, ages and corrupts what it sends, and masks receptions by
    edge liveness; joins warm-start, stragglers freeze, and the duals step
    on the true residuals with dead edges masked (``aged_duals`` also ages
    the shipped duals), as ``netsim.fit_async``.  ``RunState.k`` is the
    absolute tick, so a resumed segment replays bit for bit."""
    from repro_torch.core.graph import compile_edge_schedule

    axes = mesh.check_agent_axes(agent_axes)
    m, t = mesh.size, mesh.rank
    st = _shard_stats(stats, mesh)
    if g.m != m:
        raise ValueError(f"graph has m={g.m} agents but prod(agent axes)={m}")
    if schedule is not None:
        schedule = tuple(tuple(int(a) for a in cls) for cls in schedule)
        _validate_schedule(schedule, m)
    else:
        schedule = jacobian_schedule(m)
    in_phase = [t in cls for cls in schedule]
    sched = compile_edge_schedule(g)
    n_rounds = sched.n_rounds
    L, d, r = st.G.shape[-1], st.R.shape[-1], cfg.r
    dtype, device = st.G.dtype, st.G.device
    deg_t = torch.as_tensor(g.degrees(), dtype=dtype,
                            device=device)[t:t + 1]            # (1,)
    tau_t, zeta_t = _shard_tau_zeta(cfg, deg_t, t)
    slots = [int(x) for x in sched.slot[t]]
    own = [float(x) for x in sched.own[t]]
    robust_agg = resolve_aggregator(cfg)
    sgx = exchange.ShardedGraphExchange(g, sched, mesh, dtype, robust_agg,
                                        device=device)
    rmask = sgx.rmask
    precomp = hoist_precomp(st, cfg)
    comm = modeled_floats_per_iter("sharded_graph", L=L, r=r,
                                   n_edges=g.n_edges)

    if aged_duals and tape is None:
        raise ValueError("aged_duals=True needs tape= (the replayed tape)")
    is_adv = getattr(tape, "attack", None) is not None
    if tape is not None:
        from repro_torch.netsim.adversary import AdversaryTape
        from repro_torch.netsim.events import EventTape, validate_tape

        validate_tape(tape, g, cfg.iters)
        if len(schedule) != 1:
            raise ValueError(
                "in-mesh tape replay supports only the Jacobian sweep "
                "(schedule=None); Gauss-Seidel phases have no tape "
                "semantics")
        depth = tape.depth
        tbl = sgx.tape_tables(tape)
        # this agent's columns of the per-tick tables, kept on the host and
        # uploaded a segment at a time
        rows_np = {"age": tbl["send_age"][:, t], "live": tbl["live"][:, t],
                   "active": np.asarray(tape.active, np.float32)[:, t]}
        if is_adv:
            rows_np.update(attack=np.asarray(tape.attack)[:, t],
                           noise=np.asarray(tape.noise)[:, t],
                           member=tbl["member"][:, t],
                           member_prev=tbl["member_prev"][:, t])
            offset = torch.as_tensor(np.asarray(tape.offset), dtype=dtype,
                                     device=device)
        scalar_tau = torch.as_tensor(cfg.tau).ndim == 0
        tau0 = torch.as_tensor(cfg.tau, dtype=dtype, device=device)
        init_u = torch.ones((L, r), dtype=dtype, device=device)

    def new_diag(U, A, acc, tele):
        diag = {"obj": _local_objective(st, U[None], A[None], cfg, m),
                **{k: acc[k] for k in ("lag_pen", "primal_sq", "gamma_sum",
                                       "gamma_min")}}
        return {**diag, **tele}

    def dual_steps(lam, U_old, U_new, nb_old, nb_new, live=None):
        """The dual step on every owned round's edge; the diagnostics
        count owned edges only.  ``live`` masks dead edges' residuals."""
        lam = lam.clone()
        zero = torch.zeros((), dtype=dtype, device=device)
        acc = dict(primal_sq=zero, gamma_sum=zero, lag_pen=zero,
                   gamma_min=torch.full((), torch.inf, dtype=dtype,
                                        device=device),
                   resid_max=zero)
        for rr in range(n_rounds):
            if own[rr] == 0.0:
                continue
            resid_new = U_new - nb_new[rr]            # C_i U^{k+1} on src
            resid_old = U_old - nb_old[rr]            # C_i U^k on src
            if live is not None:
                resid_new = resid_new * live[rr]
                resid_old = resid_old * live[rr]
            lam_upd, gamma, primal = dual_step(lam[slots[rr]], resid_old,
                                               resid_new, cfg)
            lam[slots[rr]] = lam_upd
            acc["primal_sq"] = acc["primal_sq"] + primal
            acc["gamma_sum"] = acc["gamma_sum"] + gamma
            acc["gamma_min"] = torch.minimum(acc["gamma_min"], gamma)
            acc["lag_pen"] = acc["lag_pen"] + (
                torch.sum(lam_upd * resid_new)
                + 0.5 * cfg.rho * torch.sum(resid_new**2))
            if cfg.telemetry:
                acc["resid_max"] = torch.maximum(
                    acc["resid_max"], torch.max(torch.abs(resid_new)))
        return lam, acc

    def step(U, A, lam):
        U_start = U
        # C_t^T lambda: + owned duals, - every incoming dual
        ct_lam = sgx.ship_ct_lam(lam, slots, own)
        u_start_nb = sgx.exchange(U_start)  # also resid_old for the duals
        nb = u_start_nb
        agg_rejected = torch.zeros((), dtype=dtype, device=device)
        if cfg.telemetry and robust_agg is not None:
            # reduce_views returns deg_t * agg(V, Mv): the center audited
            neigh0 = sgx.reduce_views(u_start_nb, U_start, deg_t[0], rmask)
            agg_rejected = sgx.audit_views(
                u_start_nb, U_start, rmask,
                neigh0 / torch.clamp(deg_t[0], min=1.0))
        for p in range(len(schedule)):
            if p > 0:
                nb = sgx.exchange(U)            # live U: Gauss-Seidel phases
            if not in_phase[p]:
                continue
            neigh = sgx.reduce_views(nb, U, deg_t[0], rmask)
            U, A = _update_one(st, U, A, neigh, ct_lam, deg_t, tau_t, zeta_t,
                               cfg, m, precomp)
        u_new_nb = sgx.exchange(U)
        lam, acc = dual_steps(lam, U_start, U, u_start_nb, u_new_nb)
        tele = {}
        if cfg.telemetry:
            # every scheduled round delivers a fresh view: rmask counts them
            zero = torch.zeros((), dtype=dtype, device=device)
            tele = dict(resid_max=acc["resid_max"], agg_rejected=agg_rejected,
                        msgs_delivered=torch.sum(rmask), msgs_stale=zero,
                        msgs_dropped=zero)
        return U, A, lam, new_diag(U, A, acc, tele)

    def tape_step(U, A, lam, hist, lam_hist, k, row):
        age_row, live_row, act_t = row["age"], row["live"], row["active"]
        code = noise_t = None
        if is_adv:
            code, noise_t = row["attack"], row["noise"]
        # aged, corrupted views from each sender's OWN ring buffer
        recv = sgx.tape_exchange(hist, k, age_row, depth, code=code,
                                 noise_t=noise_t,
                                 offset=offset if is_adv else None,
                                 init_u=init_u)
        deg_eff = torch.sum(live_row)           # live degree (exact)
        agg_rejected = torch.zeros((), dtype=dtype, device=device)
        if robust_agg is None:
            # round-order sum; `* live_row[rr]` passes a live view through
            # bit for bit (x * 1.0)
            neigh = functools.reduce(
                torch.add, [recv[rr] * live_row[rr] for rr in range(n_rounds)])
            center = neigh / torch.clamp(deg_eff, min=1.0)
        else:
            V = torch.stack(recv + [U])
            Mv = torch.cat([live_row, sgx.ones1])
            center = robust_agg(V, Mv)
            neigh = deg_eff * center
            if cfg.telemetry:
                agg_rejected = torch.sum(exchange.aggregator_audit(V, Mv,
                                                                   center))
        tau_eff = (tau0 + deg_eff).reshape(1) if (is_adv and scalar_tau) \
            else tau_t
        aged = None
        if aged_duals:
            aged = {"lam_hist": lam_hist, "k": k, "age_row": age_row,
                    "depth": depth, "code": code, "noise": noise_t,
                    "offset": offset if is_adv else None}
        ct_lam = sgx.tape_ct_lam(lam, slots, own, live_row, aged=aged)
        if is_adv:
            # a (re)joining agent warm-starts from the aggregate of its
            # live neighbors (kept at U when it joins in isolation)
            join = (row["member"] * (1.0 - row["member_prev"])) > 0
            U_base = torch.where(join & (deg_eff > 0), center, U)
        else:
            U_base = U
        U_upd, A_upd = _update_one(
            st, U_base, A, neigh, ct_lam,
            deg_eff.reshape(1) if is_adv else deg_t, tau_eff, zeta_t, cfg,
            m, precomp)
        on = act_t > 0
        U_new = torch.where(on, U_upd, U_base).contiguous()  # stragglers
        A_new = torch.where(on, A_upd, A).contiguous()
        # synchronous duals on the TRUE residuals (fresh exchanges), dead
        # edges masked to zero so their duals freeze exactly
        nb_old = sgx.exchange(U_base)
        nb_new = sgx.exchange(U_new)
        lam, acc = dual_steps(lam, U_base, U_new, nb_old, nb_new,
                              live=live_row)
        hist[k % depth] = U_new
        if aged_duals:
            lam_hist[k % depth] = lam
        tele = {}
        if cfg.telemetry:
            # live receptions split by age (1: a fresh view); scheduled
            # rounds whose edge is dead this tick are drops
            fresh = (age_row == 1).to(dtype)
            tele = dict(resid_max=acc["resid_max"], agg_rejected=agg_rejected,
                        msgs_delivered=torch.sum(live_row * fresh),
                        msgs_stale=torch.sum(live_row * (1.0 - fresh)),
                        msgs_dropped=torch.sum(rmask - live_row))
        return U_new, A_new, lam, new_diag(U_new, A_new, acc, tele)

    def init_fn():
        hist0 = lam_hist0 = None
        if tape is not None:
            # U^0 in every slot: the "nothing delivered yet" / drop view
            hist0 = torch.ones((m, depth, L, r), dtype=dtype, device=device)
            if aged_duals:
                lam_hist0 = torch.zeros((m, depth, sched.n_slots, L, r),
                                        dtype=dtype, device=device)
        return RunState(
            U=torch.ones((m, L, r), dtype=dtype, device=device),
            A=torch.ones((m, r, d), dtype=dtype, device=device),
            lam=torch.zeros((m, sched.n_slots, L, r), dtype=dtype,
                            device=device),
            k=0, hist=hist0, lam_hist=lam_hist0)

    def revalidate_suffix(k0, n):
        """A resumed mid-tape segment re-checks the suffix it replays."""
        sl = slice(k0, k0 + n)
        if is_adv:
            suffix = AdversaryTape(
                age=np.asarray(tape.age)[sl], active=np.asarray(tape.active)[sl],
                attack=np.asarray(tape.attack)[sl],
                noise=np.asarray(tape.noise)[sl],
                offset=np.asarray(tape.offset),
                member=np.asarray(tape.member)[sl])
        else:
            suffix = EventTape(age=np.asarray(tape.age)[sl],
                               active=np.asarray(tape.active)[sl])
        validate_tape(suffix, g, start=k0)

    def segment_fn(state, n):
        k0 = int(state.k)
        U, A, lam = (state.U[t].to(device), state.A[t].to(device),
                     state.lam[t].to(device))
        rows = []
        hist = lam_hist = None
        if tape is None:
            for _ in range(n):
                U, A, lam, diag = step(U, A, lam)
                rows.append(diag)
        else:
            if k0 > 0 and n > 0:
                revalidate_suffix(k0, n)
            # the segment's tape rows, uploaded once
            sl = slice(k0, k0 + n)
            seg = {name: torch.as_tensor(
                       arr[sl], device=device,
                       dtype=(torch.int64 if name in ("age", "attack")
                              else dtype))
                   for name, arr in rows_np.items()}
            # the ring buffers are written in place: this segment's copies
            hist = state.hist[t].to(device).clone(
                memory_format=torch.contiguous_format)
            if aged_duals:
                lam_hist = state.lam_hist[t].to(device).clone(
                    memory_format=torch.contiguous_format)
            for i in range(n):
                U, A, lam, diag = tape_step(
                    U, A, lam, hist, lam_hist, k0 + i,
                    {name: x[i] for name, x in seg.items()})
                rows.append(diag)
        diags = _assemble_sharded_diags(_gather_columns(mesh, rows, cfg, U),
                                        g.n_edges, L * r)
        if tape is not None:
            diags["tape_cursor"] = torch.arange(k0, k0 + n, dtype=torch.int32,
                                                device=device)
        if cfg.telemetry:
            diags["comm_floats"] = torch.full((n,), float(comm), dtype=dtype,
                                              device=device)
        return RunState(k=k0 + n, **_gathered(mesh, U=U, A=A, lam=lam,
                                              hist=hist,
                                              lam_hist=lam_hist)), diags

    return Runner("sharded_graph", cfg, init_fn, segment_fn, mesh=mesh)


def fit_sharded_graph(
    stats: SufficientStats, mesh, agent_axes: Sequence[str], g: Graph,
    cfg: ConsensusConfig, *,
    schedule: Sequence[Sequence[int]] | None = None,
    tape=None, aged_duals: bool = False,
):
    """Consensus ADMM over ANY connected ``Graph``, one agent per rank (see
    :func:`_make_sharded_graph_runner` for the schedule, the Gauss-Seidel
    phases and the in-mesh tape replay).  Returns ``(U, A, diagnostics)``,
    the :func:`fit_sharded` contract (plus ``tape_cursor`` with a tape)."""
    runner = _make_sharded_graph_runner(stats, mesh, agent_axes, g, cfg,
                                        schedule=schedule, tape=tape,
                                        aged_duals=aged_duals)
    state, diags = runner.run()
    return state.U, state.A, diags
