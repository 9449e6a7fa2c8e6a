"""Consensus graphs for decentralized MTL (paper §III).

A numpy-only copy of the reference's ``repro/core/graph.py``: the same
generators give the same edge lists, colorings and edge schedules for the
same seeds.

The constraint ``sum_t C_t U_t = 0`` is edge-based: for every edge
``i = (s, e)`` of the undirected connected graph G, ``C_hat_i U = U_s - U_e``.
``C_t`` is the block-column of agent ``t``; useful identities (used throughout
the ADMM updates; see DESIGN.md §2):

  C_t^T C_t                  = d_t I            (d_t = degree of agent t)
  C_t^T sum_{i != t} C_i U_i = -sum_{j in N(t)} U_j
  C_t^T lambda               = sum_{i: s_i=t} lambda_i - sum_{i: e_i=t} lambda_i
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected connected graph over ``m`` agents with directed edge list."""

    m: int
    edges: Tuple[Tuple[int, int], ...]  # (s, e) with s != e

    def __post_init__(self):
        for (s, e) in self.edges:
            if not (0 <= s < self.m and 0 <= e < self.m and s != e):
                raise ValueError(f"bad edge {(s, e)} for m={self.m}")
        if not self._connected():
            raise ValueError("graph must be connected (Assumption 1)")

    def _connected(self) -> bool:
        adj = self.adjacency()
        seen = {0}
        stack = [0]
        while stack:
            u = stack.pop()
            for v in np.nonzero(adj[u])[0]:
                if v not in seen:
                    seen.add(int(v))
                    stack.append(int(v))
        return len(seen) == self.m

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    def adjacency(self) -> np.ndarray:
        a = np.zeros((self.m, self.m), dtype=np.float32)
        for (s, e) in self.edges:
            a[s, e] = 1.0
            a[e, s] = 1.0
        return a

    def degrees(self) -> np.ndarray:
        return self.adjacency().sum(axis=1)

    def incidence(self) -> np.ndarray:
        """Signed incidence S in R^{|E| x m}: S[i, s_i]=+1, S[i, e_i]=-1.

        The constraint operator is ``(C U)_i = sum_m S[i, m] U_m``.
        """
        s = np.zeros((self.n_edges, self.m), dtype=np.float32)
        for i, (a, b) in enumerate(self.edges):
            s[i, a] = 1.0
            s[i, b] = -1.0
        return s

    def sigma_max(self) -> np.ndarray:
        """Per-agent largest eigenvalue of C_t^T C_t = d_t I, i.e. d_t."""
        return self.degrees()

    def coloring(self) -> np.ndarray:
        """Greedy proper vertex coloring, largest-degree-first (Welsh-Powell).

        Returns an ``(m,)`` int array of colors in ``0..k-1`` such that no
        edge joins two vertices of the same color — so every color class can
        run a Gauss-Seidel update *phase* in parallel without read/write
        conflicts on neighbor messages.  Greedy on the degree-descending
        order uses at most ``max_t d_t + 1`` colors (exact for rings/stars).
        """
        adj = self.adjacency() > 0
        deg = adj.sum(axis=1)
        order = np.argsort(-deg, kind="stable")
        colors = np.full(self.m, -1, dtype=np.int64)
        for t in order:
            used = set(colors[adj[t]]) - {-1}
            c = 0
            while c in used:
                c += 1
            colors[t] = c
        return colors

    def chromatic_schedule(self) -> Tuple[Tuple[int, ...], ...]:
        """Color classes of :meth:`coloring` as an update schedule.

        Returns a tuple of disjoint vertex tuples covering ``0..m-1``; class
        ``p`` is an independent set, so a sweep that updates one class at a
        time (re-gathering neighbor messages between classes) is a valid
        Gauss-Seidel order for the consensus ADMM.
        """
        colors = self.coloring()
        return tuple(
            tuple(int(t) for t in np.nonzero(colors == c)[0])
            for c in range(int(colors.max()) + 1)
        )

    def edge_coloring(self) -> np.ndarray:
        """Proper EDGE coloring with at most Δ+1 colors (Misra & Gries 1992).

        Returns an ``(n_edges,)`` int array assigning each edge a color in
        ``0..k-1`` with ``k <= max_degree + 1`` such that no two edges
        sharing a vertex get the same color — so every color class is a
        *matching*, realizable as ONE round of point-to-point exchanges
        between devices (each agent sends/receives at most once per round).  This
        is the round count the edge-schedule compiler guarantees; greedy
        coloring can need up to ``2Δ - 1`` rounds, hence Misra-Gries.

        Requires a simple graph: a repeated undirected edge (in either
        orientation) is rejected — parallel consensus edges would just
        double the penalty weight, which ``ConsensusConfig.rho`` already
        controls explicitly.
        """
        if not self.edges:
            return np.zeros((0,), np.int64)
        seen: set[frozenset] = set()
        for (s, e) in self.edges:
            key = frozenset((s, e))
            if key in seen:
                raise ValueError(
                    f"parallel edge {(s, e)} (some orientation) appears "
                    f"twice; edge scheduling needs a simple graph"
                )
            seen.add(key)

        delta = int(self.degrees().max())
        n_colors = delta + 1
        adj = [[] for _ in range(self.m)]
        for (s, e) in self.edges:
            adj[s].append(e)
            adj[e].append(s)
        col: dict[frozenset, int] = {}

        def color_of(a: int, b: int) -> int:
            return col.get(frozenset((a, b)), -1)

        def used(a: int) -> set:
            return {
                col[frozenset((a, b))]
                for b in adj[a]
                if frozenset((a, b)) in col
            }

        def free(a: int) -> int:
            taken = used(a)
            for c in range(n_colors):
                if c not in taken:
                    return c
            raise AssertionError("no free color — Misra-Gries invariant broken")

        for (u, v) in self.edges:
            if color_of(u, v) != -1:
                continue
            # maximal fan of u starting at v: each next vertex's (u, .) edge
            # is colored with a color free on the previous fan vertex
            fan = [v]
            in_fan = {v}
            while True:
                d_last = free(fan[-1])
                nxt = next(
                    (w for w in adj[u]
                     if w not in in_fan and color_of(u, w) == d_last),
                    None,
                )
                if nxt is None:
                    break
                fan.append(nxt)
                in_fan.add(nxt)
            c = free(u)
            d = free(fan[-1])
            if c != d:
                # invert the cd_u path: the maximal alternating d/c path from
                # u; after the swap color d is free on u
                prev, cur, want = -1, u, d
                path = []
                while True:
                    nxt = next(
                        (w for w in adj[cur]
                         if w != prev and color_of(cur, w) == want),
                        None,
                    )
                    if nxt is None:
                        break
                    path.append((cur, nxt))
                    prev, cur = cur, nxt
                    want = c if want == d else d
                for (a, b) in path:
                    col[frozenset((a, b))] = c if color_of(a, b) == d else d
            # first fan prefix endpoint with d free (exists by the Vizing
            # argument; the prefix stays a fan under the inverted coloring)
            w_idx = None
            for j, w in enumerate(fan):
                if j > 0 and color_of(u, fan[j]) not in (
                    set(range(n_colors)) - used(fan[j - 1])
                ):
                    break  # fan property broken past here by the inversion
                if d not in used(w):
                    w_idx = j
                    break
            assert w_idx is not None, "Misra-Gries: no rotatable fan vertex"
            # rotate fan[0..w_idx]: shift each (u, f_i) color down, then give
            # the freed last edge color d
            for i in range(w_idx):
                col[frozenset((u, fan[i]))] = color_of(u, fan[i + 1])
            col[frozenset((u, fan[w_idx]))] = d

        out = np.asarray(
            [col[frozenset((s, e))] for (s, e) in self.edges], np.int64
        )
        # the guarantee IS the contract: verify properness and the Δ+1 bound
        per_vertex: dict[int, set] = {}
        for (s, e), c in zip(self.edges, out):
            assert c not in per_vertex.setdefault(s, set())
            assert c not in per_vertex.setdefault(e, set())
            per_vertex[s].add(c)
            per_vertex[e].add(c)
        assert out.max() < n_colors
        return out

    def edge_schedule(self) -> Tuple[Tuple[int, ...], ...]:
        """Edge-color classes as communication rounds: a tuple of tuples of
        EDGE INDICES into ``self.edges``; each round is a matching, the whole
        schedule covers every edge once, and there are at most Δ+1 rounds."""
        colors = self.edge_coloring()
        if colors.size == 0:
            return ()
        return tuple(
            tuple(int(i) for i in np.nonzero(colors == c)[0])
            for c in range(int(colors.max()) + 1)
        )


class EdgeSchedule(NamedTuple):
    """A ``Graph`` compiled to exchange rounds between devices (one agent
    per device, a "shard").

    Host-side metadata only (python ints / numpy arrays): the per-shard
    tables tell each shard its role in every round.

    Per round ``r`` (one edge-color class = one matching):

    * ``bidir_perms[r]`` — the permutation list ``[(s, e), (e, s), ...]``
      realizing the bidirectional neighbor exchange of the matching in ONE
      exchange (idle shards receive zeros).
    * ``dir_perms[r]``   — source→destination arcs only, used to deliver the
      per-edge duals (which live on the edge's source shard).
    * ``slot[t, r]``     — which of shard ``t``'s owned-dual slots the
      round-``r`` edge occupies (0 when idle — masked by ``own``).
    * ``own[t, r]``      — 1.0 iff shard ``t`` is the SOURCE of its round-``r``
      edge (it owns that edge's dual and performs its dual step).
    """

    rounds: Tuple[Tuple[int, ...], ...]
    bidir_perms: Tuple[Tuple[Tuple[int, int], ...], ...]
    dir_perms: Tuple[Tuple[Tuple[int, int], ...], ...]
    slot: np.ndarray       # (m, n_rounds) int32
    own: np.ndarray        # (m, n_rounds) float32
    n_slots: int           # max #edges owned by any shard (>= 1)
    n_edges: int

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)


def compile_edge_schedule(g: Graph) -> EdgeSchedule:
    """Compile any connected ``Graph`` into a minimal-round exchange schedule.

    Decomposes the edge list into ≤ Δ+1 matchings via :meth:`Graph.
    edge_coloring` and emits, per matching, the one partial permutation that
    exchanges neighbor subspaces in both directions plus the source→dest
    permutation that ships edge duals — together with the per-shard
    slot/ownership tables the shard-local program indexes its dual storage
    with.  Edge ``i = (s, e)`` keeps its dual on shard ``s`` in slot
    ``slot[s, round_of(i)]``, in ``g.edges`` order per shard, mirroring
    ``fit_dense``'s edge-major dual layout.
    """
    if g.n_edges == 0:
        # Graph(m=1, edges=()) passes the connectivity check but has no
        # consensus constraint to schedule; reject it with an actionable
        # message instead of crashing in the coloring
        raise ValueError(
            "cannot compile an edge schedule for an edgeless graph "
            "(m=1): consensus needs at least one edge — use a local fit"
        )
    rounds = g.edge_schedule()
    # owned-slot numbering: shard s owns the duals of edges with s as source,
    # numbered in g.edges order (the dense executor's edge-major layout)
    slot_of_edge = np.zeros(g.n_edges, np.int32)
    owned_count = np.zeros(g.m, np.int32)
    for i, (s, _) in enumerate(g.edges):
        slot_of_edge[i] = owned_count[s]
        owned_count[s] += 1
    n_slots = max(1, int(owned_count.max()))

    n_rounds = len(rounds)
    slot = np.zeros((g.m, n_rounds), np.int32)
    own = np.zeros((g.m, n_rounds), np.float32)
    bidir, direct = [], []
    for r, cls in enumerate(rounds):
        b, d = [], []
        for i in cls:
            s, e = g.edges[i]
            b.extend([(s, e), (e, s)])
            d.append((s, e))
            slot[s, r] = slot_of_edge[i]
            own[s, r] = 1.0
        bidir.append(tuple(b))
        direct.append(tuple(d))
    return EdgeSchedule(
        rounds=rounds, bidir_perms=tuple(bidir), dir_perms=tuple(direct),
        slot=slot, own=own, n_slots=n_slots, n_edges=g.n_edges,
    )


def spectral_gap(g: Graph) -> float:
    """Spectral gap of ``g``: λ₂ of the normalized Laplacian
    ``I - D^{-1/2} A D^{-1/2}``.

    The gap controls the consensus mixing rate — ADMM's dual convergence
    degrades as the gap closes (long chains/rings: gap ~ 1/m²; good
    expanders: gap bounded away from 0 as m grows; complete graph:
    m/(m-1), the maximum for connected graphs before bipartite effects).
    A connected graph has gap > 0; larger is better-mixing.
    """
    if g.m < 2:
        return 0.0
    a = g.adjacency()
    d = a.sum(axis=1)
    inv_sqrt = 1.0 / np.sqrt(np.maximum(d, 1e-30))
    lap = np.eye(g.m) - inv_sqrt[:, None] * a * inv_sqrt[None, :]
    eig = np.linalg.eigvalsh(lap)
    return float(eig[1])


def ring(m: int) -> Graph:
    """Ring graph: each agent talks to its two neighbours."""
    if m < 2:
        raise ValueError("ring needs m >= 2")
    edges = tuple((t, (t + 1) % m) for t in range(m)) if m > 2 else ((0, 1),)
    return Graph(m=m, edges=edges)


def chain(m: int) -> Graph:
    return Graph(m=m, edges=tuple((t, t + 1) for t in range(m - 1)))


def star(m: int) -> Graph:
    """Master-slave structure (paper Fig. 2b): agent 0 is the hub."""
    return Graph(m=m, edges=tuple((0, t) for t in range(1, m)))


def complete(m: int) -> Graph:
    return Graph(m=m, edges=tuple((i, j) for i in range(m) for j in range(i + 1, m)))


def paper_fig2a() -> Graph:
    """The 5-agent decentralized structure of paper Fig. 2(a).

    The figure shows a connected 5-agent network; we use a ring plus one
    chord, a standard rendering of the pictured topology.
    """
    return Graph(m=5, edges=((0, 1), (1, 2), (2, 3), (3, 4), (4, 0), (1, 4)))


def hypercube(d: int) -> Graph:
    """``d``-dimensional hypercube overlay: ``m = 2^d`` agents, degree ``d``,
    diameter ``d = log2(m)`` — the classic log-diameter overlay (Liu et al.
    2017's motivation for non-mesh topologies).  Vertices are bit strings;
    each edge flips one bit and is oriented low-to-high, so the edge list is
    deterministic and ``m * d / 2`` long.
    """
    if d < 1:
        raise ValueError(f"hypercube needs d >= 1, got {d}")
    m = 1 << d
    edges = tuple(
        (t, t | (1 << b))
        for t in range(m)
        for b in range(d)
        if not t & (1 << b)
    )
    return Graph(m=m, edges=edges)


def expander(
    m: int, deg: int, seed: int = 0, min_gap: float | None = None
) -> Graph:
    """Random ``deg``-regular graph — w.h.p. an expander for ``deg >= 3``,
    giving O(log m) diameter at constant per-agent degree.

    Sampled with the pairing (configuration) model: ``deg`` stubs per
    vertex, shuffled and paired; pairs that would form a self-loop or
    parallel edge throw their stubs back and the leftovers are re-shuffled
    until all are placed (a dead end — or a disconnected result — restarts
    the whole draw).  Every random draw comes from a fresh
    ``(seed, attempt)``-indexed stream, so the result is deterministic for
    a given ``seed`` regardless of how many attempts were burned.  Edges
    are oriented low-to-high and sorted — a canonical edge list.

    ``min_gap=`` certifies expansion instead of trusting "w.h.p.": draws
    whose normalized-Laplacian :func:`spectral_gap` falls below the
    threshold are resampled like disconnected ones, so the returned graph
    is a *verified* expander.  Alon-Boppana caps what is achievable:
    λ₂ ≲ 1 - 2√(deg-1)/deg (≈ 0.057 at deg=3), so ask for less than that.
    """
    if not 2 <= deg < m:
        raise ValueError(f"expander needs 2 <= deg < m, got deg={deg} m={m}")
    if (m * deg) % 2:
        raise ValueError(f"m * deg must be even, got m={m} deg={deg}")
    for attempt in range(100):
        rng = np.random.default_rng((seed, attempt))
        stubs = np.repeat(np.arange(m), deg)
        und: set[tuple[int, int]] = set()
        while stubs.size:
            rng.shuffle(stubs)
            leftover = []
            for a, b in stubs.reshape(-1, 2):
                a, b = int(a), int(b)
                edge = (min(a, b), max(a, b))
                if a == b or edge in und:
                    leftover.extend((a, b))     # throw the stubs back
                else:
                    und.add(edge)
            if len(leftover) == stubs.size:     # dead end: restart the draw
                und = None
                break
            stubs = np.asarray(leftover, dtype=np.int64)
        if und is None:
            continue
        try:
            g = Graph(m=m, edges=tuple(sorted(und)))
        except ValueError:     # disconnected draw — resample
            continue
        if min_gap is not None and spectral_gap(g) < min_gap:
            continue           # connected but poorly mixing — resample
        return g
    raise ValueError(
        f"no connected simple {deg}-regular graph on m={m} vertices"
        + (f" with spectral gap >= {min_gap}" if min_gap is not None else "")
        + f" found in 100 pairing-model draws (seed={seed}); raise deg"
        + (" or lower min_gap" if min_gap is not None else "")
    )


def erdos(m: int, p: float, seed: int = 0) -> Graph:
    """G(m, p) random graph, made connected deterministically.

    One random draw; if it is disconnected, a spanning chain is grafted on:
    walk ``t = 0..m-2`` with a union-find and add edge ``(t, t+1)`` exactly
    when ``t`` and ``t+1`` are still in different components.  This adds the
    minimum chain edges to connect the draw, terminates for every ``p``
    (including ``p = 0``, which yields the chain graph), and never resamples.
    """
    rng = np.random.default_rng(seed)
    edges = [
        (i, j)
        for i in range(m)
        for j in range(i + 1, m)
        if rng.uniform() < p
    ]
    parent = list(range(m))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for (s, e) in edges:
        parent[find(s)] = find(e)
    for t in range(m - 1):
        if find(t) != find(t + 1):
            edges.append((t, t + 1))
            parent[find(t)] = find(t + 1)
    return Graph(m=m, edges=tuple(edges))
