"""Carry numpy arrays (for instance the reference package's weights and
statistics) into the port's objects on a given device.

``Graph`` needs nothing: the port builds it from the same generator and
seed, and gets the same edge list."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.elm import ELMFeatureMap
from repro_torch.core.engine import DenseState, SufficientStats


def _tensor(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def feature_map_from_numpy(W, b, activation: str = "sigmoid",
                           device="cuda") -> ELMFeatureMap:
    """W: (n_in, L), b: (L,) -> a frozen hidden layer on ``device``."""
    return ELMFeatureMap(W=_tensor(W, device),
                         b=_tensor(b, device).reshape(-1),
                         activation=activation)


def stats_from_numpy(G, R, n=0.0, t2=0.0, device="cuda") -> SufficientStats:
    """Per-agent statistics G (m, L, L), R (m, L, d), n and t2 (m,)."""
    return SufficientStats(G=_tensor(G, device), R=_tensor(R, device),
                           n=_tensor(n, device), t2=_tensor(t2, device))


def state_from_numpy(U, A, lam, device="cuda") -> DenseState:
    """A consensus state U (m, L, r), A (m, r, d), lam (E, L, r)."""
    return DenseState(U=_tensor(U, device), A=_tensor(A, device),
                      lam=_tensor(lam, device))


def quantized_from_numpy(Hq, scales, device="cuda"):
    """int8 tiles Hq (m, N, L) and their fp32 scales (m, N / block_n,
    L / block_l), as the reference's ``ops.quantize_tiles`` returns them,
    as tensors for ``kernel.gram_tri_q``.  Hq keeps its int8 values."""
    q = np.asarray(Hq)
    if q.dtype != np.int8:
        raise ValueError(f"Hq must be int8, got {q.dtype}")
    return (torch.tensor(q, device=device),
            torch.tensor(np.asarray(scales, dtype=np.float32), device=device))
