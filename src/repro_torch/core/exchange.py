"""The neighbor-exchange layer, dense backend: fresh views and tape replay.

Between ``agent_update`` calls an executor collects the neighbor subspace
views and incoming edge duals each agent is entitled to see this round,
reduces them through ``cfg.aggregator``, and resolves the live degree and
proximal weight.  ``DenseExchange`` does it for all agents on one device
with edge-list segment sums (the mean path) or a padded ``(m, K, L, r)``
candidate table plus the agent's own U (the robust path).
``DenseTapeGather`` extends it with the event-tape semantics of the async
executor (``repro_torch.netsim``): ring-buffer age selection per directed
edge, sender-side adversary corruption (:func:`apply_attack`), membership
degree masking, and the per-delivery candidate table of the robust path.
``ShardedGraphExchange`` is the sharded executors' backend: one agent per
rank of a :class:`repro_torch.core.mesh.Mesh`, one bidirectional
:meth:`~repro_torch.core.mesh.Mesh.ppermute` per round of a compiled
:class:`~repro_torch.core.graph.EdgeSchedule`, duals shipped source to
destination, and in-mesh tape replay (each rank ages, corrupts and ships
views of its OWN published U).  The ring/torus fast path
(``engine.ring_iteration``) shares :func:`stack_ring_candidates` for its
robust reduce.  They are the counterparts of the reference's
``repro/core/exchange.py`` classes of the same names.

Summation order: every segment sum adds its terms one gather at a time, in
edge order, onto zeros: the order of a sequential segment sum (and of
``index_add_`` on the CPU, so CPU results keep their bits), on every
device.  ``index_add_`` on CUDA adds with atomics, whose order, and so the
last bits of any slot that receives three or more terms, changes from run
to run; that would break the bitwise resume of a checkpointed run.  The
tape gather sums its views through the same tables, in the same order as
``DenseExchange.neighbor_sum``, so a zero-delay tape replays the dense
executor bit for bit.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import functools

import numpy as np
import torch


class ExchangeViews(NamedTuple):
    """What one exchange round hands the update body."""

    neigh: torch.Tensor             # (m, L, r) deg_eff-weighted aggregate
    ct_lam: torch.Tensor | None     # (m, L, r) C_t^T lambda
    deg_eff: torch.Tensor           # (m,) live degree
    tau_eff: torch.Tensor | None    # (m,) proximal weight vs deg_eff
    center: torch.Tensor | None     # neigh / deg or robust center (joins)
    table: torch.Tensor | None      # robust candidate views (m, K, L, r)
    mask: torch.Tensor | None       # candidate validity mask (m, K)


def neighbor_table(g):
    """Host-side padded adjacency table: (nbr_idx, nbr_mask) numpy arrays of
    shape (m, K_max)."""
    nbrs: list[list[int]] = [[] for _ in range(g.m)]
    for s, e in g.edges:
        nbrs[s].append(e)
        nbrs[e].append(s)
    K = max((len(x) for x in nbrs), default=1) or 1
    nbr_idx = np.zeros((g.m, K), np.int32)
    nbr_mask = np.zeros((g.m, K), np.float32)
    for t, lst in enumerate(nbrs):
        nbr_idx[t, : len(lst)] = lst
        nbr_mask[t, : len(lst)] = 1.0
    return nbr_idx, nbr_mask


def delivery_table(g):
    """Host-side padded per-receiver table over the 2E directed deliveries
    (rows [0, E) = the e->s views to src, rows [E, 2E) = the s->e views to
    dst): (pad_idx, pad_mask) numpy arrays of shape (m, K_pad), the
    tape-replay robust candidate layout."""
    recv = np.concatenate([
        np.asarray([e[0] for e in g.edges], np.int64),
        np.asarray([e[1] for e in g.edges], np.int64),
    ])
    rows: list[list[int]] = [[] for _ in range(g.m)]
    for i, t in enumerate(recv):
        rows[int(t)].append(i)
    K_pad = max((len(x) for x in rows), default=1) or 1
    pad_np = np.zeros((g.m, K_pad), np.int32)
    pmask_np = np.zeros((g.m, K_pad), np.float32)
    for t, lst in enumerate(rows):
        pad_np[t, : len(lst)] = lst
        pmask_np[t, : len(lst)] = 1.0
    return pad_np, pmask_np


def apply_attack(v, code_b, noise, replay, offset):
    """The Byzantine wire-corruption chain.

    ``code_b`` broadcasts against ``v``: 1 = sign_flip, 2 = +noise,
    3 = publish ``replay`` (the initial view; the ZERO dual for shipped
    duals), 4 = +``offset`` (the shared colluding direction).  Code 0
    passes through untouched.
    """
    out = torch.where(code_b == 1, -v, v)
    out = torch.where(code_b == 2, v + noise, out)
    out = torch.where(code_b == 3, replay, out)
    return torch.where(code_b == 4, v + offset, out)


def stack_ring_candidates(views, U, deg, agg):
    """Robust reduce of the torus fast path: the per-axis ring views + own
    U as candidates (every ring neighbor is live: an all-ones mask),
    rescaled to the degree-weighted sum ``agent_update`` expects."""
    V = torch.stack(list(views) + [U], dim=0)            # (K + 1, L, r)
    Mv = torch.ones((V.shape[0],), dtype=V.dtype, device=V.device)
    return deg * agg(V, Mv)


def aggregator_audit(V, M, center):
    """Telemetry: per-candidate Byzantine-rejection flags of one robust
    reduce (the ``agg_rejected`` counter's definition).

    A candidate is flagged *rejected* when its Frobenius distance to the
    robust ``center`` is more than 10x the masked median distance of the
    valid neighbor candidates AND above ``1e-6 * (1 + ||center||_F)``.  The
    trailing candidate (own U, last in every candidate table) is
    excluded: the audit is about messages.  A clean federation audits to an
    exact zero.  ``V`` is ``(..., K, L, r)``, ``M`` ``(..., K)``; returns
    {0, 1} flags of shape ``(..., K)`` in ``V.dtype``.
    """
    d = torch.sqrt(torch.sum((V - center[..., None, :, :]) ** 2,
                             dim=(-2, -1)))
    K = V.shape[-3]
    valid = (M > 0) & (torch.arange(K, device=V.device) < K - 1)
    big = torch.finfo(d.dtype).max
    ds = torch.sort(torch.where(valid, d, big), dim=-1).values
    n = torch.clamp(torch.sum(valid, dim=-1), min=1)
    lo = torch.gather(ds, -1, ((n - 1) // 2)[..., None])[..., 0]
    hi = torch.gather(ds, -1, (n // 2)[..., None])[..., 0]
    med = 0.5 * (lo + hi)
    floor = 1e-6 * (1.0 + torch.sqrt(torch.sum(center**2, dim=(-2, -1))))
    rej = valid & (d > 10.0 * med[..., None]) & (d > floor[..., None])
    return rej.to(V.dtype)


def _segment_table(slots, rows, m: int, pad: int) -> np.ndarray:
    """(m, K) table of a segment sum: row t lists, in edge order, the
    ``rows[j]`` of every edge j with ``slots[j] == t``, padded with ``pad``
    (the index of a zero row appended to the summed tensor)."""
    lists: list[list[int]] = [[] for _ in range(m)]
    for t, row in zip(slots, rows):
        lists[t].append(row)
    K = max((len(x) for x in lists), default=0) or 1
    table = np.full((m, K), pad, np.int64)
    for t, lst in enumerate(lists):
        table[t, : len(lst)] = lst
    return table


def _fixed_order_sum(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """out[t] = sum over k of x[table[t, k]], added one column of the table
    at a time onto zeros (the padding gathers a zero row)."""
    x = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    out = x.new_zeros((table.shape[0],) + x.shape[1:])
    for k in range(table.shape[1]):
        out = out + x[table[:, k]]
    return out


class DenseExchange:
    """Edge-list gathers for the single-device executors.

    The mean path (``agg is None``) sums neighbor views in fixed edge
    order; the robust path gathers the padded ``(m, K, L, r)`` candidate
    table plus the agent's own U and reduces it through ``agg``."""

    def __init__(self, g, dtype, agg: Callable | None = None,
                 device="cuda"):
        self.m = g.m
        self.agg = agg
        self.dtype = dtype
        src = [e[0] for e in g.edges]
        dst = [e[1] for e in g.edges]
        E = len(src)
        self.src = torch.as_tensor(src, dtype=torch.int64, device=device)
        self.dst = torch.as_tensor(dst, dtype=torch.int64, device=device)
        self.deg = torch.as_tensor(g.degrees(), dtype=dtype, device=device)

        def table(slots, rows, pad):
            return torch.as_tensor(_segment_table(slots, rows, g.m, pad),
                                   device=device)

        # neighbor sums gather U rows (pad: row m), dual sums edge rows
        # (pad: row E); each side of the edge list is its own segment sum
        self.nb_src = table(src, dst, g.m)     # U[dst[j]] into slot src[j]
        self.nb_dst = table(dst, src, g.m)     # U[src[j]] into slot dst[j]
        self.edge_src = table(src, range(E), E)
        self.edge_dst = table(dst, range(E), E)
        if agg is not None:
            nbr_idx, nbr_mask = neighbor_table(g)
            self.nbr_idx = torch.as_tensor(nbr_idx, dtype=torch.int64,
                                           device=device)
            self.nbr_mask = torch.as_tensor(nbr_mask, dtype=dtype,
                                            device=device)
            self.ones_m1 = torch.ones((g.m, 1), dtype=dtype, device=device)

    def edge_diff(self, x: torch.Tensor) -> torch.Tensor:
        """C x per edge: x[s] - x[e] for every edge (s, e)."""
        return x[self.src] - x[self.dst]

    def src_dst_sum(self, x_src: torch.Tensor,
                    x_dst: torch.Tensor) -> torch.Tensor:
        """Per-edge rows summed into agents: ``x_src[j]`` into slot
        ``src[j]`` plus ``x_dst[j]`` into slot ``dst[j]``, each in edge
        order."""
        return (_fixed_order_sum(x_src, self.edge_src)
                + _fixed_order_sum(x_dst, self.edge_dst))

    def candidates(self, U: torch.Tensor):
        """The robust path's (table, mask): neighbor views + own U last."""
        V = torch.cat([U[self.nbr_idx], U[:, None]], dim=1)
        Mv = torch.cat([self.nbr_mask, self.ones_m1], dim=1)
        return V, Mv

    def neighbor_sum(self, U: torch.Tensor) -> torch.Tensor:
        """Fresh-view neighbor reduce: two segment sums over the edge list
        (mean), or the candidate table through the aggregator, times the
        degree."""
        if self.agg is None:
            return (_fixed_order_sum(U, self.nb_src)
                    + _fixed_order_sum(U, self.nb_dst))
        V, Mv = self.candidates(U)
        return self.deg[:, None, None] * self.agg(V, Mv)

    def ct_transpose(self, lam: torch.Tensor,
                     lam_dst: torch.Tensor | None = None) -> torch.Tensor:
        """C_t^T lambda: +lam on edges where t is the source, - where end;
        ``lam_dst`` is the dual the end sees where it is not ``lam`` (the
        async executor's aged duals)."""
        return (_fixed_order_sum(lam, self.edge_src)
                - _fixed_order_sum(lam if lam_dst is None else lam_dst,
                                   self.edge_dst))

    def audit(self, U: torch.Tensor) -> torch.Tensor:
        """Telemetry (robust path only): rebuild this round's candidate
        table and count :func:`aggregator_audit` rejections, a 0-d
        tensor."""
        V, Mv = self.candidates(U)
        return torch.sum(aggregator_audit(V, Mv, self.agg(V, Mv)))

    def gather_views(self, published: torch.Tensor,
                     duals: torch.Tensor) -> ExchangeViews:
        """Fresh views: ``published`` is the live stacked U.  Tape-driven
        gathers go through :class:`DenseTapeGather`."""
        return ExchangeViews(
            neigh=self.neighbor_sum(published),
            ct_lam=self.ct_transpose(duals),
            deg_eff=self.deg,
            tau_eff=None,
            center=None,
            table=None,
            mask=None,
        )


class DenseTapeCtx(NamedTuple):
    """Per-tick tape rows for :class:`DenseTapeGather`: the EventTape rows,
    plus the AdversaryTape rows when present."""

    age_k: torch.Tensor                 # (2, E) int
    k: int                              # absolute tick
    code_k: torch.Tensor | None = None  # (m,) attack codes
    noise_k: torch.Tensor | None = None
    member_k: torch.Tensor | None = None


class DenseTapeGather:
    """Event-tape view gather over a :class:`DenseExchange` (the async
    executor).

    Serves each directed edge the aged view the tape dictates (ring-buffer
    slot ``(k - age) mod depth``, computed on the device), applies the
    sender's wire corruption, masks dead edges out of every reduction, and
    resolves the live degree / scalar-tau proximal weight."""

    def __init__(self, ex: DenseExchange, g, cfg, depth: int, is_adv: bool,
                 init_U, offset, tau_t):
        self.ex = ex
        self.depth = depth
        self.is_adv = is_adv
        self.init_U = init_U
        self.offset = offset
        device = ex.deg.device
        self.scalar_tau = torch.as_tensor(cfg.tau).ndim == 0
        self.tau0 = torch.as_tensor(cfg.tau, dtype=ex.dtype, device=device)
        self.tau_t = tau_t  # the per-agent resolved weight (full membership)
        if ex.agg is not None:
            pad_np, pmask_np = delivery_table(g)
            self.pad_idx = torch.as_tensor(pad_np, dtype=torch.int64,
                                           device=device)
            self.pad_mask = torch.as_tensor(pmask_np, dtype=ex.dtype,
                                            device=device)
            self.ones_m1 = torch.ones((g.m, 1), dtype=ex.dtype,
                                      device=device)

    def __call__(self, hist, U, ctx: DenseTapeCtx):
        """-> ``(view0, view1, slot1, el, views)``: the aged (corrupted)
        views per directed edge, the s -> e ring slots (the aged duals ride
        them), the per-edge live mask (None without an adversary tape), and
        the :class:`ExchangeViews` without ``ct_lam`` (it needs the dual
        mode, so the executor gathers it)."""
        ex = self.ex
        src, dst = ex.src, ex.dst
        slot0 = torch.remainder(ctx.k - ctx.age_k[0], self.depth)  # e -> s
        slot1 = torch.remainder(ctx.k - ctx.age_k[1], self.depth)  # s -> e
        view0 = hist[slot0, dst]                            # (E, L, r)
        view1 = hist[slot1, src]
        if self.is_adv:
            code_k, noise_k, member_k = ctx.code_k, ctx.noise_k, ctx.member_k

            def corrupt(v, c, sender):
                return apply_attack(v, c[:, None, None], noise_k[sender],
                                    self.init_U[sender], self.offset)

            view0 = corrupt(view0, code_k[dst], dst)
            view1 = corrupt(view1, code_k[src], src)
            el = member_k[src] * member_k[dst]              # (E,)
            elb = el[:, None, None]
            deg_eff = ex.src_dst_sum(el, el)
            tau_eff = self.tau0 + deg_eff if self.scalar_tau else self.tau_t
            v0, v1 = view0 * elb, view1 * elb
        else:
            el = None
            deg_eff, tau_eff = ex.deg, self.tau_t
            v0, v1 = view0, view1
        if ex.agg is None:
            neigh = ex.src_dst_sum(v0, v1)
            center = (neigh / torch.clamp(deg_eff, min=1.0)[:, None, None]
                      if self.is_adv else None)
            table = mask = None
        else:
            W = torch.cat([view0, view1], dim=0)            # (2E, L, r)
            mv = self.pad_mask
            if self.is_adv:
                live2 = torch.cat([el, el])
                mv = mv * live2[self.pad_idx]
            table = torch.cat([W[self.pad_idx], U[:, None]], dim=1)
            mask = torch.cat([mv, self.ones_m1], dim=1)
            center = ex.agg(table, mask)
            neigh = deg_eff[:, None, None] * center
        views = ExchangeViews(neigh=neigh, ct_lam=None, deg_eff=deg_eff,
                              tau_eff=tau_eff, center=center, table=table,
                              mask=mask)
        return view0, view1, slot1, el, views


class ShardedGraphExchange:
    """Masked-ppermute rounds over a compiled edge schedule, one agent per
    rank.

    Built on every rank from the same host-side schedule; the methods run
    on this rank's agent alone, on unbatched ``(L, r)`` blocks, and every
    rank calls them in the same order (each ppermute is a collective of the
    mesh).  The mean path sums the round views in round order
    (``functools.reduce``, zeros on idle rounds); the robust path stacks
    them with this rank's round-participation mask and own U, so idle
    rounds' zeros are EXCLUDED, never candidates."""

    def __init__(self, g, sched, mesh, dtype, agg: Callable | None = None,
                 device="cuda"):
        self.g = g
        self.sched = sched
        self.mesh = mesh
        self.dtype = dtype
        self.agg = agg
        self.n_rounds = sched.n_rounds
        # rmask[t, rr] = 1 iff round rr delivers a partner's U to agent t;
        # a row sums to the agent's degree
        rmask = np.zeros((g.m, self.n_rounds), np.float32)
        for rr in range(self.n_rounds):
            for _s, dd in sched.bidir_perms[rr]:
                rmask[dd, rr] = 1.0
        self.rmask_all = rmask
        self.rmask = torch.as_tensor(rmask[mesh.rank], dtype=dtype,
                                     device=device)
        self.ones1 = torch.ones((1,), dtype=dtype, device=device)

    def exchange(self, x: torch.Tensor) -> list:
        """One bidirectional ppermute per round: round rr delivers the
        round-rr partner's x (zeros when idle)."""
        return [self.mesh.ppermute(x, self.sched.bidir_perms[rr])
                for rr in range(self.n_rounds)]

    def reduce_views(self, nb, U, deg_t, rmask):
        """Round views -> the ``agent_update`` neighbor sum: the round-order
        sum (mean), or ``deg_t`` times the robust center over the
        round-live views + own U."""
        if self.agg is None:
            return functools.reduce(torch.add, nb)
        V = torch.stack(list(nb) + [U], dim=0)           # (rounds + 1, L, r)
        Mv = torch.cat([rmask, self.ones1])
        return deg_t * self.agg(V, Mv)

    def audit_views(self, nb, U, rmask, center):
        """Telemetry (robust path): this rank's :func:`aggregator_audit`
        rejections over the round views + own U, a 0-d tensor (``rmask``
        the participation mask, or the tape's live row under replay)."""
        V = torch.stack(list(nb) + [U], dim=0)
        Mv = torch.cat([rmask, self.ones1])
        return torch.sum(aggregator_audit(V, Mv, center))

    def ship_ct_lam(self, lam, slots, own):
        """C_t^T lambda: + the duals this rank owns (unowned slots stay
        zero), - every incoming dual, shipped source -> destination per
        round.  ``slots``/``own`` are this rank's schedule rows."""
        ct_lam = torch.sum(lam, dim=0)
        for rr in range(self.n_rounds):
            lam_send = own[rr] * lam[slots[rr]]
            ct_lam = ct_lam - self.mesh.ppermute(lam_send,
                                                 self.sched.dir_perms[rr])
        return ct_lam

    # ---------------------------------------------------------------- tape

    def tape_tables(self, tape) -> dict:
        """Host-side per-(tick, agent, round) tables of in-mesh replay.

        ``send_age[k, t, rr]`` is the age of the message agent ``t`` SENDS
        on its round-``rr`` edge at tick ``k`` (its directed edge's tape
        row): the sender reads slot ``(k - send_age) mod depth`` of its OWN
        published history, so one ppermute still moves every message.
        ``live[k, t, rr]`` masks the round for both endpoints when either
        is a non-member at tick ``k`` (zero on idle rounds)."""
        g, sched = self.g, self.sched
        iters, m = tape.iters, g.m
        age = np.asarray(tape.age)
        member = getattr(tape, "member", None)
        member = (np.ones((iters, m), np.float32) if member is None
                  else np.asarray(member, np.float32))
        send_age = np.ones((iters, m, self.n_rounds), np.int32)
        live = np.zeros((iters, m, self.n_rounds), np.float32)
        for rr, cls in enumerate(sched.rounds):
            for i in cls:
                s, e = g.edges[i]
                # direction 1 is s -> e: s's outgoing age; 0 is e -> s
                send_age[:, s, rr] = age[:, 1, i]
                send_age[:, e, rr] = age[:, 0, i]
                el = member[:, s] * member[:, e]
                live[:, s, rr] = el
                live[:, e, rr] = el
        member_prev = (np.concatenate([member[:1], member[:-1]], axis=0)
                       if iters else member)
        return {"send_age": send_age, "live": live, "member": member,
                "member_prev": member_prev}

    def tape_exchange(self, hist, k, age_row, depth, code=None, noise_t=None,
                      offset=None, init_u=None) -> list:
        """Send-side aged (and corrupted) exchange: per round this rank
        picks the view its age asks for from its OWN ring buffer ``hist``
        (depth, L, r), corrupts it with its OWN attack code, and the
        bidirectional ppermute delivers.  The caller masks receptions by
        the ``live`` row."""
        outs = []
        for rr in range(self.n_rounds):
            # a 1-element index tensor: a gather on the device, no host sync
            slot = torch.remainder(k - age_row[rr:rr + 1], depth)
            v = hist[slot][0]
            if code is not None:
                v = apply_attack(v, code, noise_t, init_u, offset)
            outs.append(self.mesh.ppermute(v, self.sched.bidir_perms[rr]))
        return outs

    def tape_ct_lam(self, lam, slots, own, live_row, *, aged=None):
        """C_t^T lambda under membership masking: + the owned duals with
        dead owned edges removed (``own - gate`` is an exact zero on a live
        edge, so a zero-adversary tape keeps the no-tape gather's values
        bit for bit), - the received duals, sender-masked.  ``aged`` (a
        dict with lam_hist/k/age_row/depth and optional code/noise/offset)
        ships the age-selected, sender-corrupted ``lam_hist`` slot instead
        (a replayed dual is the ZERO initial dual)."""
        ct_lam = torch.sum(lam, dim=0)
        for rr in range(self.n_rounds):
            gate = own[rr] * live_row[rr]
            ct_lam = ct_lam - (own[rr] - gate) * lam[slots[rr]]
            if aged is None:
                lam_send = gate * lam[slots[rr]]
            else:
                slot = torch.remainder(aged["k"] - aged["age_row"][rr:rr + 1],
                                       aged["depth"])
                lv = aged["lam_hist"][slot, slots[rr]][0]
                if aged.get("code") is not None:
                    lv = apply_attack(lv, aged["code"], aged["noise"],
                                      torch.zeros_like(lv), aged["offset"])
                lam_send = gate * lv
            ct_lam = ct_lam - self.mesh.ppermute(lam_send,
                                                 self.sched.dir_perms[rr])
        return ct_lam
