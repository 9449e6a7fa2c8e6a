"""Analytic communication models: floats shipped per consensus
iteration, per executor, against the subspace payload L·r:

  dense / colored / async   every edge delivers the published U both
                            ways (2·E) and ships one dual λ (E)
                            → 3·E·L·r
  sharded (ring/torus)      per agent axis: 3 neighbour hops of U (left,
                            right, and the return shift) + 1 λ hop, for
                            every agent slot → 4·m·n_axes·L·r
  sharded_graph             the compiled edge schedule's 2 bidirectional
                            U exchanges + 1 λ ship per edge
                            → 5·E·L·r

``cfg.telemetry`` runs stamp this as the per-iteration ``comm_floats``
diag key.  The same numbers as the reference's ``repro.obs.counters``
(the port's tests hold the two equal); the port runs the dense and colored
executors today.
"""

from __future__ import annotations


def modeled_floats_per_iter(
    executor: str,
    *,
    L: int,
    r: int,
    n_edges: int | None = None,
    m: int | None = None,
    n_axes: int | None = None,
) -> int:
    """Floats moved per iteration for ``executor`` (module docstring)."""
    if executor in ("dense", "colored", "async"):
        if n_edges is None:
            raise ValueError(f"{executor} model needs n_edges")
        return 3 * n_edges * L * r
    if executor == "sharded":
        if m is None or n_axes is None:
            raise ValueError("sharded model needs m and n_axes")
        return 4 * m * n_axes * L * r
    if executor == "sharded_graph":
        if n_edges is None:
            raise ValueError("sharded_graph model needs n_edges")
        return 5 * n_edges * L * r
    raise ValueError(f"unknown executor for comm model: {executor!r}")
