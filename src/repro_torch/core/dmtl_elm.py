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
``engine.fit_colored``, the event-tape async executor ``engine.fit_async``,
or the one-agent-per-rank ``engine.fit_sharded`` / ``fit_sharded_graph``)
runs the iterations.

Solver choice (cfg.u_solver — ``engine.U_SOLVERS``): "kron" (the paper's
eq. 19), "sylvester" (exact, eigh(G_t) hoisted), "cg", "pcg" (Jacobi-
preconditioned CG, the backbone-scale choice); cfg.first_order=True needs
no solve at all (eq. 23).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from repro_torch.checkpoint import run_checkpointed
from repro_torch.core import engine, sharded_dmtl
from repro_torch.core.engine import ConsensusConfig, DenseState
from repro_torch.core.graph import Graph
from repro_torch.obs import report as obs_report
from repro_torch.obs import trace as obs_trace

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
    tape=None,
    channel=None,
    aged_duals: bool = False,
    mesh=None,
    agent_axes=None,
    feature_map=None,
    use_kernel: bool = True,
    checkpoint_dir=None,
    checkpoint_every: int = 0,
    resume: bool = False,
    telemetry: bool = False,
    trace_dir=None,
    health=None,
) -> tuple[DMTLELMState, dict]:
    """The DMTL-ELM entry point: stats pass, then the consensus iterations.

    ``executor="dense"`` is the synchronous Jacobian sweep;
    ``executor="colored"`` the Gauss-Seidel colored sweep
    (``engine.fit_colored``, with ``schedule=``, ``staleness=`` and
    ``order=``; ``staleness``/``order`` apply to it alone);
    ``executor="async"`` the event-driven asynchrony of
    ``repro_torch.netsim`` (``engine.fit_async``): pass either a precomputed
    ``tape=`` (an ``EventTape`` or ``AdversaryTape``) or a ``channel=`` (a
    ``ChannelModel``, sampled here over ``cfg.iters`` ticks of ``g``);
    ``aged_duals=True`` also ships the received duals through the lossy
    channel.  ``executor="sharded"`` runs one agent per rank of
    ``mesh=`` (a :class:`repro_torch.core.mesh.Mesh`) over ``agent_axes=``:
    every rank calls ``fit`` and reduces only its own agent's rows of H
    and T (the global stack, or its own (1, N, ...) block).  ``g`` that is
    the mesh ring/torus (up to edge orientation) takes the torus fast path
    (``engine.fit_sharded``); any other graph, a ``schedule=`` (Gauss-Seidel
    phases in the mesh) or a ``tape=``/``channel=`` (in-mesh replay,
    ``aged_duals`` too) takes the compiled schedule
    (``engine.fit_sharded_graph``).  ``cfg.aggregator`` picks the neighbor
    reduction of every executor (``engine.AGGREGATORS``).
    ``cfg.stats_precision`` picks the Gram pass's precision ("fp32" |
    "bf16" | "int8").  The stats pass honors ``cfg.stats_producer``: with
    ``"fused"`` the first argument is the RAW per-agent input X
    (m, N, d_in) and ``feature_map=`` is required, the hidden layer running
    inside the Gram kernel.  ``use_kernel=False`` takes the Gram kernels'
    plain versions on any device.

    Checkpointed runs: ``checkpoint_dir=`` drives the run through
    ``repro_torch.checkpoint.run_checkpointed``, which saves a resumable
    snapshot (state + full diagnostics prefix) every ``checkpoint_every``
    iterations (0 = once, at the end); ``resume=True`` restarts from the
    latest snapshot when one exists.  A resumed run returns the final state
    and the full diagnostics trajectory bit for bit as the uninterrupted
    run on the same device.

    Observability (``repro_torch.obs``): ``telemetry=True`` sets
    ``cfg.telemetry`` (per-iteration comm/aggregator counters in the
    diagnostics); ``trace_dir=`` records spans around the stats pass and
    every segment, then writes ``trace.json`` (Chrome trace format),
    ``spans.jsonl`` and a run report (``report.md`` / ``report.json``)
    there; ``health=`` (``True`` or a ``HealthConfig``) arms the
    run-health monitor at checkpoint segment boundaries (so it needs
    ``checkpoint_dir=``): a NaN, diverging or stalled run stops early with
    a ``dnf_reason`` in its last snapshot's metadata.

    Returns ``(DMTLELMState, diagnostics)`` with per-iteration
    'objective', 'lagrangian', 'consensus', 'gamma', 'gamma_min' and
    'primal_sq'; ``executor="sharded"`` returns ``(U (m, L, r),
    A (m, r, d), diagnostics)``, the same on every rank, and rank 0 alone
    writes checkpoints, traces and reports."""
    # All validation happens BEFORE the Gram reduction.
    if executor not in EXECUTORS:
        raise ValueError(
            f"unknown executor {executor!r}; expected one of {EXECUTORS}"
        )
    if executor not in ("colored", "sharded") and schedule is not None:
        raise ValueError(
            "schedule= only applies to executor='colored' or 'sharded', "
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
    if cfg.aggregator not in engine.AGGREGATORS:
        raise ValueError(
            f"unknown cfg.aggregator {cfg.aggregator!r}; registered: "
            f"{sorted(engine.AGGREGATORS)}"
        )
    if executor != "sharded" and (mesh is not None or agent_axes is not None):
        raise ValueError(
            f"mesh=/agent_axes= only apply to executor='sharded', "
            f"got executor={executor!r}"
        )
    if executor not in ("async", "sharded") and (
        tape is not None or channel is not None or aged_duals
    ):
        raise ValueError(
            f"tape=/channel=/aged_duals= only apply to executor='async' or "
            f"'sharded', got executor={executor!r}"
        )
    if executor == "async":
        if (tape is None) == (channel is None):
            raise ValueError(
                "executor='async' needs exactly one of tape= (a precompiled "
                "EventTape) or channel= (a ChannelModel to sample)"
            )
        if channel is not None:
            tape = channel.sample(g, cfg.iters)
    if checkpoint_dir is None and (checkpoint_every or resume):
        raise ValueError(
            "checkpoint_every=/resume= need checkpoint_dir= to point at "
            "the snapshot directory"
        )
    if checkpoint_every < 0:
        raise ValueError(
            f"checkpoint_every must be >= 0, got {checkpoint_every}"
        )
    if health is not None and health is not False and checkpoint_dir is None:
        raise ValueError(
            "health= monitoring runs at checkpoint segment boundaries; "
            "pass checkpoint_dir= (and checkpoint_every=) to arm it"
        )
    if executor == "sharded":
        if mesh is None or agent_axes is None:
            raise ValueError(
                "executor='sharded' needs mesh= and agent_axes="
            )
        n_agents = math.prod(mesh.shape[a] for a in agent_axes)
        if g.m != n_agents:
            raise ValueError(
                f"graph has m={g.m} agents but prod(agent axes)={n_agents}"
            )
        # the dispatcher validates tape=/channel=/aged_duals= before each
        # rank reduces only its own agent's rows
        return sharded_dmtl._dispatch_sharded(
            None, mesh, agent_axes, cfg, g, schedule=schedule, tape=tape,
            channel=channel, aged_duals=aged_duals,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            resume=resume, telemetry=telemetry, trace_dir=trace_dir,
            health=health, stats_fn=lambda: engine.produce_stats(
                engine.own_rows(H, mesh), engine.own_rows(T, mesh),
                producer=cfg.stats_producer, feature_map=feature_map,
                precision=cfg.stats_precision, use_kernel=use_kernel))
    if telemetry:
        cfg = dataclasses.replace(cfg, telemetry=True)
    tracer = None
    trace_ctx = contextlib.nullcontext()
    if trace_dir is not None:
        tracer = obs_trace.Tracer()
        trace_ctx = obs_trace.use(tracer)
    with trace_ctx:
        stats = engine.produce_stats(
            H, T, producer=cfg.stats_producer, feature_map=feature_map,
            precision=cfg.stats_precision, use_kernel=use_kernel,
        )
        runner = engine.make_runner(
            stats, g, cfg, executor=executor, schedule=schedule,
            staleness=staleness, order=order, tape=tape,
            aged_duals=aged_duals)
        if checkpoint_dir is not None:
            state, diags = run_checkpointed(
                runner, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, resume=resume,
                health=health,
            )
        else:
            state, diags = runner.run()
    if tracer is not None:
        tracer.export(trace_dir)
        obs_report.write(
            trace_dir, diags, tracer.spans,
            meta={
                "executor": executor, "m": g.m, "n_edges": g.n_edges,
                "iters": cfg.iters, "aggregator": cfg.aggregator,
                "telemetry": bool(cfg.telemetry),
            },
        )
    return DenseState(state.U, state.A, state.lam), diags


def dmtl_elm_predict(U_t, A_t, H) -> torch.Tensor:
    return H @ U_t @ A_t
