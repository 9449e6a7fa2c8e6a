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
They are the counterparts of the reference's
``repro/core/exchange.py::DenseExchange`` and ``DenseTapeGather``; the
sharded backend comes with the sharded executors (ROADMAP queue 1 item 5).

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
