"""The neighbor-exchange layer, dense backend on the mean path.

Between ``agent_update`` calls an executor collects the neighbor subspace
views and incoming edge duals each agent is entitled to see this round.
``DenseExchange`` does it for all agents on one device with edge-list
segment sums.  It is the counterpart of the reference's
``repro/core/exchange.py::DenseExchange`` on the mean aggregator; the robust
aggregators and the tape gather come with netsim (ROADMAP queue 1 item 4),
the sharded backend with the sharded executors (item 5).

Summation order: every segment sum adds its terms one gather at a time, in
edge order, onto zeros: the order of a sequential segment sum (and of
``index_add_`` on the CPU, so CPU results keep their bits), on every
device.  ``index_add_`` on CUDA adds with atomics, whose order, and so the
last bits of any slot that receives three or more terms, changes from run
to run; that would break the bitwise resume of a checkpointed run.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch


class ExchangeViews(NamedTuple):
    """What one exchange round hands the update body."""

    neigh: torch.Tensor      # (m, L, r) sum of neighbor U
    ct_lam: torch.Tensor     # (m, L, r) C_t^T lambda
    deg_eff: torch.Tensor    # (m,) degree


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
    """Edge-list gathers for the single-device executor (mean path)."""

    def __init__(self, g, dtype, agg: Callable | None = None,
                 device="cuda"):
        if agg is not None:
            raise NotImplementedError(
                "robust aggregators are not ported yet: they come with "
                "netsim, ROADMAP queue 1 item 4; only the mean path is "
                "available"
            )
        self.m = g.m
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

    def edge_diff(self, x: torch.Tensor) -> torch.Tensor:
        """C x per edge: x[s] - x[e] for every edge (s, e)."""
        return x[self.src] - x[self.dst]

    def neighbor_sum(self, U: torch.Tensor) -> torch.Tensor:
        """sum_{j in N(t)} U_j: two segment sums over the edge list."""
        return (_fixed_order_sum(U, self.nb_src)
                + _fixed_order_sum(U, self.nb_dst))

    def ct_transpose(self, lam: torch.Tensor) -> torch.Tensor:
        """C_t^T lambda: +lam on edges where t is the source, - where end."""
        return (_fixed_order_sum(lam, self.edge_src)
                - _fixed_order_sum(lam, self.edge_dst))

    def gather_views(self, published: torch.Tensor,
                     duals: torch.Tensor) -> ExchangeViews:
        """Fresh views: ``published`` is the live stacked U."""
        return ExchangeViews(
            neigh=self.neighbor_sum(published),
            ct_lam=self.ct_transpose(duals),
            deg_eff=self.deg,
        )
