"""The async executor: event-driven asynchrony around the unchanged ADMM body.

``fit_async`` drives ``engine.agent_update``, the same per-agent round every
other executor runs, under a precomputed :class:`EventTape`: each tick reads
its tape row (per-directed-edge message ages, per-agent active mask), so
delay/drop/straggler simulation adds no host round trip.  The reference
(``repro.netsim.executor``) scans the tape inside one compiled program; here
the ticks are a Python loop over eager PyTorch ops, as in the dense
executor, and a segment's tape rows are uploaded to the device once, at its
start.  Nothing in a tick reads a device value back to the host.

Mechanics per tick ``k``:

* A ``depth``-deep ring buffer of published subspaces serves each directed
  edge the *stale* neighbor view the tape dictates: ``age = a`` reads the
  ``U`` published at the end of tick ``k - a`` (slot ``(k - a) mod depth``,
  computed on the device; slots the run has not reached yet still hold the
  initial ``U^0``, which is exactly the "nothing delivered yet" /
  all-dropped fallback: a dropped message leaves the receiver on its last
  delivered view, never on zeros).
* The body runs over ALL agents; the tape's ``active`` mask then keeps
  stragglers' ``(U, A)`` unchanged (they republish their old state).
* The edge duals are the executor's synchronous bookkeeping, as in
  ``fit_colored``'s staleness mode: ``dual_step`` runs on the true edge
  residuals each tick.  ``aged_duals=True`` also ships the *received* dual
  through the same lossy channel (a second ring buffer of dual views, aged
  like the ``s -> e`` message it rides).

Segmented execution (:func:`make_async_runner`): the executor is an
``engine.Runner`` whose :class:`engine.RunState` carries the ring buffers
(``hist``, and ``lam_hist`` iff ``aged_duals``) and whose ``k`` IS the tape
cursor: each segment takes tape rows ``[k, k + n)`` and uses the ABSOLUTE
tick for the ring slots, so any mid-tape checkpoint/resume replays bit for
bit.  A resumed segment (``k > 0``) re-validates the tape suffix it is
about to replay (``validate_tape(..., start=k)``).  Every diagnostics row
also reports ``tape_cursor``, the absolute tick it was computed at.

Adversary and membership (``AdversaryTape``, duck-typed on ``.attack``):
published views are corrupted per directed edge by the sender's attack code
(``aged_duals`` corrupts the shipped dual the same way, a replayed dual
being the zero initial dual), and the per-tick ``member`` row drives
elastic membership: dead edges leave every reduction (the live degree
re-resolves the scalar-tau proximal weight; masked residuals freeze the
dead edge's dual), absent agents freeze like stragglers, and a (re)joining
agent warm-starts from the aggregate of its live neighbors.
``cfg.aggregator`` picks the neighbor reduction: ``"mean"`` keeps the
segment sums, the robust rules feed the delivered (possibly corrupted)
views and the receiver's own U through ``engine.AGGREGATORS``, dead
deliveries masked out.

Identities, bit for bit on the same device (``tests/test_torch_netsim.py``,
and on the card ``chip_smoke.py`` phase 5c):

* ``zero_delay_tape``  -> ``engine.fit_dense``, with live or aged duals;
* ``constant_tape(k)`` -> ``fit_colored(staleness=k,
  schedule=jacobian_schedule(m))``;
* all-dropped channel  -> ``fit_colored(staleness=iters, ...)`` (every view
  pinned at ``U^0``);
* a zero-attack full-membership ``AdversaryTape`` -> the same run on its
  base ``EventTape``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine, exchange
from repro_torch.core.engine import (
    AgentState,
    ConsensusConfig,
    DenseState,
    NeighborMsgs,
    Runner,
    RunState,
    SufficientStats,
    dual_step,
)
from repro_torch.core.graph import Graph
from repro_torch.netsim.adversary import AdversaryTape
from repro_torch.netsim.events import EventTape, validate_tape
from repro_torch.obs.counters import modeled_floats_per_iter


def make_async_runner(
    stats: SufficientStats,
    g: Graph,
    cfg: ConsensusConfig,
    tape: EventTape,
    *,
    aged_duals: bool = False,
) -> Runner:
    """Segmented event-tape executor: ``RunState.k`` is the tape cursor.

    The tape must carry exactly ``cfg.iters`` ticks for ``g``'s edge list;
    ``run_segment(state, n)`` replays ticks ``[state.k, state.k + n)``.
    """
    if tape is None:
        raise ValueError(
            "executor='async' needs tape= (an EventTape or AdversaryTape, "
            "e.g. netsim.ChannelModel(...).sample(g, cfg.iters))"
        )
    validate_tape(tape, g, cfg.iters)
    es = engine._edge_setup(stats, g, cfg)
    stats, ex = es.stats, es.ex
    m, E = stats.G.shape[0], g.n_edges
    dtype, device = stats.G.dtype, stats.G.device
    depth = tape.depth
    edge_ids = torch.arange(E, device=device)
    comm = modeled_floats_per_iter("async", L=stats.G.shape[-1], r=cfg.r,
                                   n_edges=E)

    # host tape rows; the adversary fields are read only with an
    # AdversaryTape, so the plain-tape mean path runs exactly the dense
    # executor's ops, and every adversary op passes values through
    # unchanged under zero attack and full membership
    rows_np = {"age": np.asarray(tape.age), "active": np.asarray(tape.active)}
    is_adv = getattr(tape, "attack", None) is not None
    robust = ex.agg is not None
    offset = None
    if is_adv:
        member = np.asarray(tape.member, np.float32)
        # member at the previous tick (tick 0: the initial roster, so a
        # tick-0 "joiner" does not warm-start off nothing)
        rows_np.update(
            attack=np.asarray(tape.attack), noise=np.asarray(tape.noise),
            member=member,
            member_prev=(np.concatenate([member[:1], member[:-1]], axis=0)
                         if member.shape[0] else member))
        offset_np = np.asarray(tape.offset)
        offset = torch.as_tensor(offset_np, dtype=dtype, device=device)
    row_dtypes = {"age": torch.int64, "attack": torch.int64}
    gather = exchange.DenseTapeGather(ex, g, cfg, depth, is_adv, es.init.U,
                                      offset, es.tau_t)

    def step(U, A, lam, hist, lam_hist, k, row):
        age_k, act_k = row["age"], row["active"]
        if is_adv:
            code_k, noise_k = row["attack"], row["noise"]
            member_k = row["member"]
            ctx = exchange.DenseTapeCtx(age_k, k, code_k, noise_k, member_k)
        else:
            ctx = exchange.DenseTapeCtx(age_k, k)
        # aged (possibly corrupted) neighbor views per directed edge, summed
        # per receiving agent in the order of the dense executor's
        # neighbor_sum, so the zero-delay tape is bit for bit fit_dense
        _, _, slot1, el, gv = gather(hist, U, ctx)
        elb = el[:, None, None] if is_adv else None
        lam_own = lam * elb if is_adv else lam
        lam_seen = None
        if aged_duals:
            # the end of an edge sees the dual that rode the s -> e
            # message; the source reads its own live dual
            lam_seen = lam_hist[slot1, edge_ids]
            if is_adv:
                # corrupted by the same sender (src); a replayed dual is
                # the ZERO initial dual
                lam_seen = exchange.apply_attack(
                    lam_seen, code_k[ex.src][:, None, None],
                    noise_k[ex.src], torch.zeros_like(lam_seen), offset,
                ) * elb
        elif is_adv:
            lam_seen = lam_own      # a dead edge's dual leaves the gather
        ct_lam = ex.ct_transpose(lam_own, lam_seen)
        if is_adv:
            # a (re)joining agent warm-starts from the aggregate of its
            # live neighbors (kept at U when it rejoins into isolation)
            join = (member_k * (1.0 - row["member_prev"]))[:, None, None] > 0
            U_base = torch.where(join & (gv.deg_eff[:, None, None] > 0),
                                 gv.center, U)
        else:
            U_base = U
        msgs = NeighborMsgs(gv.neigh, ct_lam, gv.deg_eff, gv.tau_eff,
                            es.zeta_t)
        U_upd, A_upd = engine.agent_update(
            stats, AgentState(U_base, A), msgs, cfg, m_total=m,
            precomp=es.precomp)
        on = act_k[:, None, None] > 0
        # stragglers republish; contiguous, as the dense executor's state
        U_new = torch.where(on, U_upd, U_base).contiguous()
        A_new = torch.where(on, A_upd, A).contiguous()
        resid_old = ex.edge_diff(U_base)
        resid_new = ex.edge_diff(U_new)
        if is_adv:
            # masked residuals freeze a dead edge's dual: primal == 0 on
            # the edge, so dual_step's increment is exactly zero there
            resid_old = resid_old * elb
            resid_new = resid_new * elb
        lam_new, gamma, primal = dual_step(lam, resid_old, resid_new, cfg)
        hist[k % depth] = U_new
        if aged_duals:
            lam_hist[k % depth] = lam_new
        diag = engine._iteration_diag(stats, cfg, U_new, A_new, lam_new,
                                      resid_new, gamma, primal)
        if cfg.telemetry:
            # per-directed-edge delivery accounting off the tape row: age 1
            # is a fresh (current-round) view, age > 1 a stale ring-buffer
            # serve; dead edges (membership churn) are drops
            fresh = (age_k == 1).to(dtype)
            if is_adv:
                live = el[None, :]
                diag["msgs_delivered"] = torch.sum(fresh * live)
                diag["msgs_stale"] = torch.sum((1.0 - fresh) * live)
                diag["msgs_dropped"] = 2.0 * torch.sum(1.0 - el)
            else:
                diag["msgs_delivered"] = torch.sum(fresh)
                diag["msgs_stale"] = torch.sum(1.0 - fresh)
                diag["msgs_dropped"] = torch.zeros((), dtype=dtype,
                                                   device=device)
            diag["agg_rejected"] = (
                torch.sum(exchange.aggregator_audit(gv.table, gv.mask,
                                                    gv.center))
                if robust else torch.zeros((), dtype=dtype, device=device))
        return U_new, A_new, lam_new, diag

    def init_fn():
        # slot j holds the U published at the end of tick j (mod depth).
        # Ages are in [1, depth], so slot (k - a) mod depth is never
        # overwritten before tick k reads it, and pre-history reads land on
        # slots the run has not written yet: still U^0, the drop fallback
        U0 = es.init.U
        lam_hist0 = (torch.zeros((depth,) + tuple(es.init.lam.shape),
                                 dtype=dtype, device=device)
                     if aged_duals else None)
        return RunState(U=U0, A=es.init.A, lam=es.init.lam, k=0,
                        hist=U0.expand((depth,) + tuple(U0.shape)),
                        lam_hist=lam_hist0)

    def segment_fn(state, n):
        k0 = int(state.k)
        sl = slice(k0, k0 + n)
        if k0 > 0 and n > 0:
            # resumed mid-tape: re-check the suffix about to be replayed
            if is_adv:
                suffix = AdversaryTape(
                    age=rows_np["age"][sl], active=rows_np["active"][sl],
                    attack=rows_np["attack"][sl], noise=rows_np["noise"][sl],
                    offset=offset_np, member=rows_np["member"][sl])
            else:
                suffix = EventTape(age=rows_np["age"][sl],
                                   active=rows_np["active"][sl])
            validate_tape(suffix, g, start=k0)
        # the segment's tape rows, uploaded once
        seg = {name: torch.as_tensor(arr[sl],
                                     dtype=row_dtypes.get(name, dtype),
                                     device=device)
               for name, arr in rows_np.items()}
        # the ring buffers are written in place: materialize this segment's
        # own copies (the initial hist is a stride-0 view, and the caller's
        # state, a restored checkpoint say, must not change)
        hist = state.hist.clone(memory_format=torch.contiguous_format)
        lam_hist = (state.lam_hist.clone(memory_format=torch.contiguous_format)
                    if aged_duals else None)
        U, A, lam = state.U, state.A, state.lam
        rows = []
        for i in range(n):
            U, A, lam, diag = step(U, A, lam, hist, lam_hist, k0 + i,
                                   {name: x[i] for name, x in seg.items()})
            rows.append(diag)
        keys = engine.DIAG_KEYS + (engine.TELEMETRY_KEYS if cfg.telemetry
                                   else ())
        diags = engine._stack_rows(rows, keys, U)
        diags["tape_cursor"] = torch.arange(k0, k0 + n, dtype=torch.int32,
                                            device=device)
        if cfg.telemetry:
            diags["comm_floats"] = torch.full((n,), float(comm), dtype=dtype,
                                              device=device)
        return RunState(U=U, A=A, lam=lam, k=k0 + n, hist=hist,
                        lam_hist=lam_hist), diags

    return Runner("async", cfg, init_fn, segment_fn)


def fit_async(
    stats: SufficientStats,
    g: Graph,
    cfg: ConsensusConfig,
    tape: EventTape,
    *,
    aged_duals: bool = False,
) -> tuple[DenseState, dict]:
    """Run consensus ADMM under the simulated asynchrony of ``tape``.

    The contract of :func:`engine.fit_dense` (final stacked ``DenseState``
    and the shared per-iteration diagnostics, plus ``tape_cursor``); the
    tape must carry exactly ``cfg.iters`` ticks for ``g``'s edge list.
    One segment of :func:`make_async_runner` driven to completion."""
    runner = make_async_runner(stats, g, cfg, tape, aged_duals=aged_duals)
    state, diags = runner.run()
    return DenseState(state.U, state.A, state.lam), diags
