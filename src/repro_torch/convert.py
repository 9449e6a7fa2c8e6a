"""Carry numpy arrays (for instance the reference package's weights and
statistics) into the port's objects on a given device.

``model_from_numpy`` takes the reference's ``init_model`` pytree (arrays
that numpy can read) and lays it out as the port's flat layer list.

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


def _tree_tensors(tree, device, index=None):
    """Nested dicts/tuples of arrays -> the same nesting (tuples as lists)
    of fp32 tensors; ``index`` takes one entry of every leaf's leading
    axis."""
    if isinstance(tree, dict):
        return {k: _tree_tensors(v, device, index) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_tensors(v, device, index) for v in tree]
    a = np.asarray(tree)
    return _tensor(a if index is None else a[index], device)


def model_from_numpy(params, cfg, device="cuda"):
    """The reference's model parameters -> the port's, on ``device``.

    Every leaf of ``params["cycles"]`` carries a leading n_cycles axis
    (``jax.vmap(cycle_init)``): cycle c, block j becomes layer
    c * len(cfg.block_pattern) + j, and ``params["rem"]`` follows the
    cycles.  Dense weights keep their (d_in, d_out) orientation; every
    leaf becomes fp32."""
    if params.get("encoder") is not None:
        raise NotImplementedError(
            "encoder-decoder models come with the LM-substrate slice")
    n_cycles = cfg.n_layers // len(cfg.block_pattern)
    layers = []
    for c in range(n_cycles):
        layers.extend(_tree_tensors(blk, device, c) for blk in params["cycles"])
    layers.extend(_tree_tensors(blk, device) for blk in params["rem"])
    if len(layers) != cfg.n_layers:
        raise ValueError(
            f"params hold {len(layers)} layers, cfg {cfg.name!r} has "
            f"{cfg.n_layers}")
    out = {"embed": _tree_tensors(params["embed"], device),
           "final_norm": _tree_tensors(params["final_norm"], device),
           "layers": layers}
    if "lm_head" in params:
        out["lm_head"] = _tree_tensors(params["lm_head"], device)
    return out
