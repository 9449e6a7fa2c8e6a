"""Streaming stats accumulation: the pipeline-side bridge into the consensus
engine.  ``stream_sufficient_stats`` folds an iterator of per-agent batches
into :class:`~repro_torch.core.engine.SufficientStats`, so multi-task ELM
heads can be fitted over data that never fully materializes."""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch

from repro_torch.core.engine import (
    SufficientStats,
    _kahan_add,
    accumulate_stats,
    accumulate_stats_chunked,
    init_stats,
)


def stream_sufficient_stats(
    feature_batches: Iterable[Tuple[torch.Tensor, torch.Tensor]],
    stats: SufficientStats | None = None,
    *,
    chunk: Optional[int] = None,
    use_kernel: bool = True,
    precision: str = "fp32",
    compensated: bool = False,
    producer: str = "materialized",
    feature_map=None,
    quant_seed: int = 0,
) -> SufficientStats:
    """Fold a stream of per-agent batches into SufficientStats.

    ``feature_batches`` yields (H, T) with H: (m, B, L), T: (m, B, d); each
    batch goes through the engine's Gram producer (on the card: ONE launch
    of the triangular kernel for all m agents).  ``chunk`` caps the rows
    folded per producer call.

    ``producer="fused"`` (with ``feature_map=``) takes RAW inputs: batches
    yield (X, T) with X: (m, B, d_in), and ``H = act(X W + b)`` is computed
    inside the Gram kernel.

    ``precision="int8"`` (materialized only) quantizes each producer call
    with its own rounding stream: the i-th call of the whole stream (a
    batch, or a chunk of one) rounds with seed ``quant_seed + i``, the
    per-chunk rule of ``accumulate_stats_chunked`` carried across batches.

    ``compensated=True`` carries Kahan compensation for the running G/R/t2
    totals across the WHOLE stream: each batch is reduced from zero, then
    folded in through one compensated add."""

    def empty_stats(H, T):
        L = feature_map.L if producer == "fused" else H.shape[-1]
        return init_stats(H.shape[0], L, T.shape[-1], torch.float32,
                          device=H.device)

    def reduce(start, H, T, kahan, seed):
        if chunk is not None and H.shape[1] > chunk:
            return accumulate_stats_chunked(
                start, H, T, chunk, use_kernel=use_kernel,
                precision=precision, compensated=kahan, producer=producer,
                feature_map=feature_map, quant_seed=seed)
        return accumulate_stats(start, H, T, use_kernel=use_kernel,
                                precision=precision, producer=producer,
                                feature_map=feature_map, quant_seed=seed)

    comp = None
    seed = quant_seed
    for H, T in feature_batches:
        batch_seed = seed
        seed += -(-H.shape[1] // chunk) if chunk is not None else 1
        if stats is None:
            stats = empty_stats(H, T)
        if not compensated:
            stats = reduce(stats, H, T, False, batch_seed)
            continue
        b = reduce(empty_stats(H, T), H, T, True, batch_seed)
        t2_run = torch.as_tensor(stats.t2, dtype=torch.float32,
                                 device=b.t2.device).expand(b.t2.shape)
        if comp is None:
            comp = (torch.zeros_like(stats.G), torch.zeros_like(stats.R),
                    torch.zeros_like(t2_run))
        G, cG = _kahan_add(stats.G, comp[0], b.G)
        R, cR = _kahan_add(stats.R, comp[1], b.R)
        t2, ct2 = _kahan_add(t2_run, comp[2], b.t2)
        comp = (cG, cR, ct2)
        stats = SufficientStats(G=G, R=R, n=stats.n + b.n, t2=t2)
    if stats is None:
        raise ValueError(
            "stream_sufficient_stats: empty feature stream and no initial "
            "stats — pass `stats=init_stats(...)` or a non-empty iterator"
        )
    return stats
