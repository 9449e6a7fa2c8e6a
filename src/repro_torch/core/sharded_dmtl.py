"""Sharded DMTL-ELM: one agent per rank, consensus over the mesh.

Algorithm 2 as the paper deploys it: each agent keeps its data, and only
its subspace ``U_t`` and its edge duals cross to its neighbors.  The agents
are the ranks of a :class:`repro_torch.core.mesh.Mesh` (``("data",)`` on
one host, ``("pod", "data")`` across hosts), and the consensus graph is
the ring/torus of its axes, or any connected ``Graph`` compiled to
ppermute rounds (``g=``).  Every rank calls the same entry point.

The update math lives in ``repro_torch.core.engine``: ``ring_iteration``
(the torus fast path) and ``fit_sharded_graph`` (the compiled schedule,
its Gauss-Seidel phases and in-mesh tape replay) around the one shared
``agent_update``.  This module keeps the reference's entry points:
``dmtl_fit_from_stats`` (the streaming-statistics path of
``repro_torch.core.heads``) and ``dmtl_elm_fit_sharded`` (raw data).

Per iteration each agent sends 3 ppermutes of U and 1 of lambda per agent
axis on the torus path; the compiled path ``rounds * (phases + 1)``
U-ppermutes and ``rounds`` dual-ppermutes, ``rounds <= Δ+1``.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.checkpoint import run_checkpointed
from repro_torch.core import engine
from repro_torch.core.engine import ConsensusConfig as DMTLELMConfig
from repro_torch.core.engine import ShardState as ShardedDMTLState  # noqa: F401
from repro_torch.core.engine import SufficientStats, ring_iteration  # noqa: F401
from repro_torch.core.graph import Graph
from repro_torch.obs import report as obs_report
from repro_torch.obs import trace as obs_trace


def _dispatch_sharded(stats, mesh, agent_axes, cfg, g: Optional[Graph], *,
                      schedule=None, tape=None, channel=None,
                      aged_duals: bool = False,
                      checkpoint_dir=None, checkpoint_every: int = 0,
                      resume: bool = False, telemetry: bool = False,
                      trace_dir=None, health=None, stats_fn=None):
    """The torus fast path when ``g`` is None or is the mesh torus (up to
    edge orientation); the compiled edge schedule otherwise, and always
    under a ``schedule=`` (Gauss-Seidel phases in the mesh) or a tape.
    ``tape=``/``channel=`` need an explicit ``g`` (the tape is indexed by
    its edge list).  Everything is validated before ``stats_fn`` (the
    raw-data entries) reduces this rank's own data inside the trace."""
    if tape is not None and channel is not None:
        raise ValueError("pass at most one of tape= or channel=")
    if (tape is not None or channel is not None) and g is None:
        raise ValueError(
            "tape=/channel= need an explicit g= (the tape is indexed by "
            "the graph's edge list, not the mesh torus)")
    if channel is not None:
        tape = channel.sample(g, cfg.iters)
    if aged_duals and tape is None:
        raise ValueError("aged_duals=True needs a tape= or channel=")
    if health is not None and health is not False and checkpoint_dir is None:
        raise ValueError(
            "health= monitoring runs at checkpoint segment boundaries; "
            "pass checkpoint_dir= (and checkpoint_every=) to arm it")
    torus = g is None
    if not torus and tape is None and schedule is None:
        sizes = [mesh.shape[ax] for ax in agent_axes]
        torus = (all(s >= 2 for s in sizes)
                 and engine.graph_matches_torus(g, sizes))
    if telemetry:
        cfg = dataclasses.replace(cfg, telemetry=True)
    tracer = None
    trace_ctx = contextlib.nullcontext()
    if trace_dir is not None:
        tracer = obs_trace.Tracer()
        trace_ctx = obs_trace.use(tracer)
    exec_name = "sharded" if torus else "sharded_graph"
    with trace_ctx:
        if stats_fn is not None:
            stats = stats_fn()
        runner = engine.make_runner(
            stats, g, cfg, executor=exec_name, mesh=mesh,
            agent_axes=agent_axes, schedule=schedule, tape=tape,
            aged_duals=aged_duals)
        if checkpoint_dir is not None:
            state, diags = run_checkpointed(
                runner, checkpoint_dir=checkpoint_dir,
                checkpoint_every=checkpoint_every, resume=resume,
                health=health)
        else:
            state, diags = runner.run()
    if tracer is not None and mesh.rank == 0:
        # once, as the reference's single controller writes them
        meta = {"executor": exec_name, "m": mesh.size}
        if g is not None:
            meta["n_edges"] = g.n_edges
        tracer.export(trace_dir)
        obs_report.write(trace_dir, diags, tracer.spans, meta={
            **meta, "iters": cfg.iters, "aggregator": cfg.aggregator,
            "telemetry": bool(cfg.telemetry)})
    return state.U, state.A, diags


def dmtl_fit_from_stats(
    G_all: torch.Tensor,
    HtT_all: torch.Tensor,
    mesh,
    agent_axes: Sequence[str],
    cfg: DMTLELMConfig,
    *,
    n=None,
    t2=None,
    g: Optional[Graph] = None,
    tape=None,
    channel=None,
    aged_duals: bool = False,
    checkpoint_dir=None,
    checkpoint_every: int = 0,
    resume: bool = False,
    telemetry: bool = False,
    trace_dir=None,
    health=None,
):
    """ADMM over precomputed per-agent Gram statistics.

    ``G_all`` (m, L, L) = H_t^T H_t and ``HtT_all`` (m, L, d) = H_t^T T_t,
    the global stack or this rank's own (1, ...) block.  ``n`` (samples)
    and ``t2`` (sum of squared targets) make the 'objective' and
    'lagrangian' diagnostics exact; without them the fit is the same and
    those diagnostics lack the constant ||T||^2 term.  ``g`` picks a
    non-torus graph (compiled to ppermute rounds); ``tape=`` (an
    ``EventTape``/``AdversaryTape``) or ``channel=`` (a ``ChannelModel``
    sampled over cfg.iters) replays a lossy network in the mesh and needs
    ``g``; ``aged_duals=True`` ships the duals through it too.
    ``checkpoint_dir=``/``checkpoint_every=``/``resume=`` and
    ``telemetry=``/``trace_dir=``/``health=`` as in
    ``repro_torch.core.dmtl_elm.fit`` (rank 0 writes snapshots, traces and
    reports).  Every rank gets ``(U (m, L, r), A (m, r, d), diagnostics)``.
    """
    stats = SufficientStats(G=G_all, R=HtT_all,
                            n=0.0 if n is None else n,
                            t2=0.0 if t2 is None else t2)
    return _dispatch_sharded(
        stats, mesh, agent_axes, cfg, g, tape=tape, channel=channel,
        aged_duals=aged_duals, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, resume=resume,
        telemetry=telemetry, trace_dir=trace_dir, health=health)


def dmtl_elm_fit_sharded(
    H: torch.Tensor,
    T: torch.Tensor,
    mesh,
    agent_axes: Sequence[str],
    cfg: DMTLELMConfig,
    *,
    g: Optional[Graph] = None,
    tape=None,
    channel=None,
    aged_duals: bool = False,
    checkpoint_dir=None,
    checkpoint_every: int = 0,
    resume: bool = False,
    telemetry: bool = False,
    trace_dir=None,
    health=None,
    use_kernel: bool = True,
):
    """Raw-data entry: H (m, N, L) and T (m, N, d), the global stack or this
    rank's own (1, N, ...) block.  Each rank reduces only its own agent's
    rows to statistics (one Gram launch on a CUDA tensor,
    ``cfg.stats_precision``), then runs :func:`dmtl_fit_from_stats`'s
    dispatch.  Returns ``(U (m, L, r), A (m, r, d), diagnostics)`` on every
    rank."""
    return _dispatch_sharded(
        None, mesh, agent_axes, cfg, g, tape=tape, channel=channel,
        aged_duals=aged_duals, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every, resume=resume,
        telemetry=telemetry, trace_dir=trace_dir, health=health,
        stats_fn=lambda: engine.produce_stats(
            engine.own_rows(H, mesh), engine.own_rows(T, mesh),
            precision=cfg.stats_precision, use_kernel=use_kernel))
