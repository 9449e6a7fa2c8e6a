"""Decode-time state: KV caches (full lines and sliding-window rings) and
recurrent states.

The port's layout is flat and mirrors ``params["layers"]``:

    {"pos": (B,) int32, "layers": [the entry of layer l, ...]}

(the reference stacks the entries of its full layer cycles on a leading
axis, ``cache["cycles"]``, and keeps the remainder in ``cache["rem"]``;
``convert.cache_from_numpy`` unstacks them).  Batch is dim 0 of every
tensor.  One position counter ``pos`` is shared by all layers.  RoPE is
applied to keys before they are cached, so ring slots need no position
bookkeeping beyond validity.  Recurrent states are fp32 whatever the cache
dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.kernels.mlstm.ref import NEG   # the stabilizers' start
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvquant import quant_entry
from repro_torch.models.rglru import RGLRUState
from repro_torch.models.xlstm import MLSTMState, SLSTMState

def _attn_entry(cfg: ModelConfig, batch: int, max_len: int, dtype, device):
    if cfg.kv_quant:
        return quant_entry(cfg, batch, max_len, device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _mlstm_entry(cfg: ModelConfig, batch: int, device) -> MLSTMState:
    H = cfg.n_heads
    D = int(cfg.mlstm_proj_factor * cfg.d_model) // H
    return MLSTMState(
        C=torch.zeros((batch, H, D, D), device=device),
        n=torch.zeros((batch, H, D), device=device),
        m=torch.full((batch, H), NEG, device=device))


def _slstm_entry(cfg: ModelConfig, batch: int, device) -> SLSTMState:
    H = cfg.n_heads
    shape = (batch, H, cfg.d_model // H)
    return SLSTMState(*(torch.zeros(shape, device=device) for _ in range(3)),
                      m=torch.full(shape, NEG, device=device))


def _rglru_entry(cfg: ModelConfig, batch: int, device) -> RGLRUState:
    return RGLRUState(
        h=torch.zeros((batch, cfg.d_rnn), device=device),
        conv=torch.zeros((batch, cfg.conv1d_width - 1, cfg.d_rnn),
                         device=device))


def block_cache_entry(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None):
    """The cache entry of one block of ``kind``: a KV line of ``max_len``
    slots (``attn``), a ring of ``min(sliding_window, max_len)`` slots
    (``swa``), or the recurrent state (``rglru``, ``mlstm``, ``slstm``).
    ``device=None`` means ``cuda``."""
    if cfg.is_encdec:
        raise NotImplementedError(
            "cross-attention caches of encoder-decoder models come with the "
            "encoder-decoder slice")
    device = "cuda" if device is None else device
    if kind == "attn":
        return _attn_entry(cfg, batch, max_len, dtype, device)
    if kind == "swa":
        return _attn_entry(cfg, batch, min(cfg.sliding_window, max_len),
                           dtype, device)
    if kind == "mlstm":
        return _mlstm_entry(cfg, batch, device)
    if kind == "slstm":
        return _slstm_entry(cfg, batch, device)
    if kind == "rglru":
        return _rglru_entry(cfg, batch, device)
    if kind == "moe":
        raise NotImplementedError(
            "block kind 'moe' is not ported yet; it comes with the MoE slice")
    raise ValueError(f"unknown block kind {kind}")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """The whole decode cache, one entry per layer, zero positions."""
    device = "cuda" if device is None else device
    return {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "layers": [block_cache_entry(cfg, kind, batch, max_len, dtype, device)
                   for kind in cfg.layer_kinds()],
    }

