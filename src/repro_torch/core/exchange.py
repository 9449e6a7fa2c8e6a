"""The neighbor-exchange layer, dense backend on the mean path.

Between ``agent_update`` calls an executor collects the neighbor subspace
views and incoming edge duals each agent is entitled to see this round.
``DenseExchange`` does it for all agents on one device with edge-list
segment sums (``index_add_``).  It is the counterpart of the reference's
``repro/core/exchange.py::DenseExchange`` on the mean aggregator; the robust
aggregators, the tape gather and the sharded backend belong to later port
slices.

Summation order: ``index_add_`` on CUDA adds with atomics.  Every agent of a
degree-2 ring receives exactly one term per segment sum, so there the sums
are exact; on graphs with a degree above 2 the order (and hence the last
ulp) can differ from the reference's sequential segment sum.
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


class DenseExchange:
    """Edge-list gathers for the single-device executor (mean path)."""

    def __init__(self, g, dtype, agg: Callable | None = None,
                 device="cuda"):
        if agg is not None:
            raise NotImplementedError(
                "robust aggregators are not ported yet: they come with the "
                "netsim slice, port slice 2 (only the mean path is available)"
            )
        self.m = g.m
        self.src = torch.as_tensor([e[0] for e in g.edges], dtype=torch.int64,
                                   device=device)
        self.dst = torch.as_tensor([e[1] for e in g.edges], dtype=torch.int64,
                                   device=device)
        self.deg = torch.as_tensor(g.degrees(), dtype=dtype, device=device)

    def _segment_sum(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((self.m,) + x.shape[1:], dtype=x.dtype,
                          device=x.device)
        return out.index_add_(0, idx, x)

    def edge_diff(self, x: torch.Tensor) -> torch.Tensor:
        """C x per edge: x[s] - x[e] for every edge (s, e)."""
        return x[self.src] - x[self.dst]

    def neighbor_sum(self, U: torch.Tensor) -> torch.Tensor:
        """sum_{j in N(t)} U_j: two segment sums over the edge list."""
        return (self._segment_sum(U[self.dst], self.src)
                + self._segment_sum(U[self.src], self.dst))

    def ct_transpose(self, lam: torch.Tensor) -> torch.Tensor:
        """C_t^T lambda: +lam on edges where t is the source, - where end."""
        return (self._segment_sum(lam, self.src)
                - self._segment_sum(lam, self.dst))

    def gather_views(self, published: torch.Tensor,
                     duals: torch.Tensor) -> ExchangeViews:
        """Fresh views: ``published`` is the live stacked U."""
        return ExchangeViews(
            neigh=self.neighbor_sum(published),
            ct_lam=self.ct_transpose(duals),
            deg_eff=self.deg,
        )
