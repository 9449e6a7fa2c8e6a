"""Carry numpy arrays (for instance the reference package's weights and
statistics) into the port's objects on a given device.

``model_from_numpy`` takes the reference's ``init_model`` pytree (arrays
that numpy can read) and lays it out as the port's flat layer list (and
an encoder-decoder's encoder as a list of its blocks);
``cache_from_numpy`` does the same for a decode cache (``prefill``'s), so
that the port can decode on from a cache that the reference filled.

``Graph`` needs nothing: the port builds it from the same generator and
seed, and gets the same edge list."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.elm import ELMFeatureMap
from repro_torch.core.engine import DenseState, SufficientStats
from repro_torch.models.kvquant import QuantizedKV
from repro_torch.models.rglru import RGLRUState
from repro_torch.models.xlstm import MLSTMState, SLSTMState


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
    cycles.  An encoder-decoder's ``params["encoder"]``, stacked on a
    leading n_enc_layers axis, becomes the list of its blocks, beside
    ``enc_norm``.  MoE blocks' (E, d, F) expert weights keep their layout.
    Dense weights keep their (d_in, d_out) orientation; every leaf becomes
    fp32."""
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
    if params.get("encoder") is not None:
        out["encoder"] = [_tree_tensors(params["encoder"], device, i)
                          for i in range(cfg.n_enc_layers)]
        out["enc_norm"] = _tree_tensors(params["enc_norm"], device)
    return out


def _array_tensor(x, device) -> torch.Tensor:
    """An array -> a tensor of its own dtype on ``device``; bfloat16 arrays
    (numpy has no such dtype: the reference's are ml_dtypes') go through
    their 16-bit pattern."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _entry_from_numpy(entry, kind: str, device, index=None):
    """One layer's cache entry; ``index`` takes one cycle of stacked
    leaves."""

    def leaf(x):
        return _array_tensor(x if index is None else np.asarray(x)[index],
                             device)

    if kind in ("attn", "swa", "moe"):
        if not {"k", "v"} <= set(entry) <= {"k", "v", "ck", "cv"}:
            raise ValueError(f"an attention entry holds k, v and an "
                             f"encoder-decoder's ck, cv; got {sorted(entry)}")
        out = {}
        for name, line in entry.items():
            # the reference's QuantizedKV is a (q, scale) named tuple
            out[name] = (QuantizedKV(*(leaf(t) for t in line))
                         if isinstance(line, tuple) else leaf(line))
        return out
    state = {"rglru": RGLRUState, "mlstm": MLSTMState,
             "slstm": SLSTMState}.get(kind)
    if state is None:
        raise ValueError(f"unknown block kind {kind}")
    return state(*(leaf(t) for t in entry))


def cache_from_numpy(cache, cfg, device="cuda"):
    """The reference's decode cache (``init_cache``/``prefill``, arrays that
    numpy can read: ``jax.tree.map(np.asarray, cache)``) -> the port's
    ``{"pos", "layers"}`` on ``device``.  Cycle c's entry j becomes layer
    c * len(cfg.block_pattern) + j, and ``cache["rem"]`` follows, as in
    ``model_from_numpy``.  Every tensor keeps its dtype (int8 lines and
    their bf16 scales included); the named state tuples become the port's
    ``RGLRUState``, ``MLSTMState`` and ``SLSTMState``."""
    pattern = cfg.block_pattern
    n_cycles = cfg.n_layers // len(pattern)
    layers = []
    for c in range(n_cycles):
        layers.extend(_entry_from_numpy(e, kind, device, c)
                      for e, kind in zip(cache["cycles"], pattern))
    kinds, first = cfg.layer_kinds(), len(layers)
    layers.extend(_entry_from_numpy(e, kinds[first + i], device)
                  for i, e in enumerate(cache["rem"]))
    if len(layers) != cfg.n_layers:
        raise ValueError(
            f"cache holds {len(layers)} layers, cfg {cfg.name!r} has "
            f"{cfg.n_layers}")
    return {"pos": _array_tensor(cache["pos"], device).to(torch.int32),
            "layers": layers}
