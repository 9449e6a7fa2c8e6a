"""Stats-first consensus engine, dense executor (the single-device slice).

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
    staleness and the Gauss-Southwell class order.  The async and sharded
    executors come with netsim and the sharded executors (ROADMAP queue 1
    items 4 and 5).

Telemetry (``cfg.telemetry=True``; the observability layer,
``repro_torch.obs``): every executor additionally reports, per iteration,

  resid_max       max |C U| over the edges (worst-agent consensus)
  msgs_delivered  fresh deliveries this iteration
  msgs_stale      stale-served deliveries (colored sweeps, staleness > 1)
  msgs_dropped    deliveries masked out (0: no executor here drops any)
  agg_rejected    robust-aggregation rejections (0 on the mean path, the
                  only aggregator ported)
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
from typing import Callable, NamedTuple, Sequence

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
    # Neighbor aggregation: only the paper's plain sum ("mean") is ported.
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
    if cfg.aggregator != "mean":
        raise NotImplementedError(
            f"aggregator={cfg.aggregator!r}: the robust aggregators are not "
            f"ported yet; they come with netsim, ROADMAP queue 1 item 4; "
            f"only 'mean' is available"
        )
    m, L = stats.G.shape[0], stats.G.shape[-1]
    d = stats.R.shape[-1]
    dtype, device = stats.G.dtype, stats.G.device

    def per_agent(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device).expand(m)

    # scalar n/t2 get the agent axis every other leaf has
    stats = SufficientStats(G=stats.G, R=stats.R, n=per_agent(stats.n),
                            t2=per_agent(stats.t2))
    ex = exchange.DenseExchange(g, dtype, device=device)
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
    """The mid-run state the single-device executors advance."""

    U: torch.Tensor     # (m, L, r) stacked subspaces
    A: torch.Tensor     # (m, r, d) stacked heads
    lam: torch.Tensor   # (E, L, r) per-edge duals
    k: int              # iterations done
    # colored with staleness s: (s, m, L, r), hist[j] = U published at the
    # end of iteration k - s + j (U^0 before the start); None otherwise
    hist: torch.Tensor | None = None


@dataclasses.dataclass(frozen=True)
class Runner:
    """A segmented executor: ``init_state()`` + ``run_segment(state, n)``.
    Splitting ``cfg.iters`` into segments runs the same sequence of
    updates as one uninterrupted run."""

    executor: str
    cfg: ConsensusConfig
    init_fn: Callable[[], RunState]
    segment_fn: Callable[[RunState, int], tuple[RunState, dict]]

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


def _diag_rows(rows: list, like: torch.Tensor, cfg: ConsensusConfig,
               comm_floats: int, n_edges: int, fresh: float) -> dict:
    """Stack per-iteration diagnostics rows into (n,) tensors; with
    ``cfg.telemetry`` also ``resid_max`` and the constant counters of the
    runner: ``fresh`` of the 2·E neighbor deliveries arrive fresh, the rest
    stale, none is dropped, the mean aggregator rejects nothing, and
    ``comm_floats`` floats move."""
    keys = DIAG_KEYS + (("resid_max",) if cfg.telemetry else ())
    diags = {
        key: (torch.stack([r[key] for r in rows]) if rows
              else torch.zeros((0,), dtype=like.dtype, device=like.device))
        for key in keys
    }
    if cfg.telemetry:
        for key, value in (("msgs_delivered", fresh),
                           ("msgs_stale", 2.0 * n_edges - fresh),
                           ("msgs_dropped", 0.0), ("agg_rejected", 0.0),
                           ("comm_floats", comm_floats)):
            diags[key] = torch.full((len(rows),), float(value),
                                    dtype=like.dtype, device=like.device)
    return diags


def make_runner(
    stats: SufficientStats, g: Graph, cfg: ConsensusConfig, *,
    executor: str = "dense",
    schedule: Sequence[Sequence[int]] | None = None,
    staleness: int = 0, order: str = "fixed",
) -> Runner:
    """The segmented :class:`Runner` of a single-device executor:
    ``executor="dense"`` (behind :func:`fit_dense`) or ``"colored"``
    (behind :func:`fit_colored`, with ``schedule``/``staleness``/``order``).
    ``runner.run()`` reproduces the ``fit_*`` call; ``runner.run(state)``
    starts from a given :class:`RunState`."""
    if executor == "colored":
        return _colored_runner(stats, g, cfg, schedule=schedule,
                               staleness=staleness, order=order)
    if executor in ("async", "sharded", "sharded_graph"):
        raise NotImplementedError(
            f"executor={executor!r} is not ported yet: it comes with "
            + ("netsim, ROADMAP queue 1 item 4" if executor == "async"
               else "the sharded executors (port slice 3), ROADMAP queue 1 "
                    "item 5")
        )
    if executor != "dense":
        raise ValueError(
            f"unknown executor {executor!r}; expected one of 'dense', "
            f"'colored', 'async', 'sharded', 'sharded_graph'"
        )
    if schedule is not None or staleness != 0 or order != "fixed":
        raise ValueError(
            "schedule=/staleness=/order= only apply to executor='colored'"
        )
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
        resid_old = es.ex.edge_diff(U)
        resid_new = es.ex.edge_diff(U_new)
        lam_new, gamma, primal = dual_step(lam, resid_old, resid_new, cfg)
        diag = _iteration_diag(stats, cfg, U_new, A_new, lam_new, resid_new,
                               gamma, primal)
        # the solvers may return column-major layouts, and a BLAS call's
        # last bits can follow the layout: the carried state is kept in the
        # layout a restored checkpoint has, so a resumed run repeats the
        # uninterrupted one bit for bit
        return U_new.contiguous(), A_new.contiguous(), lam_new, diag

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
