"""Int8 KV caches: per-row symmetric int8 with a bf16 scale per row.

    k_q = round(k / s),  s = max(max|k|, 1e-6) / 127      (per written row)

A row is one (position, head) vector of head_dim values, so the scale costs
1/head_dim of the int8 bytes and a cache line takes about half the bytes of
a bf16 one.  ``torch.round`` rounds half to even, as the reference's
``jnp.round`` does, so both packages store the same int8 values.  Enabled by
``ModelConfig.kv_quant = True`` (decode caches only: prefill and training
activations stay in the compute dtype).  Reads dequantize the whole line into
the compute dtype before the attention products (plain torch, as the
reference computes them in jnp; no kernel).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedKV(NamedTuple):
    q: torch.Tensor       # int8, the cache line's shape
    scale: torch.Tensor   # bf16, the line's shape with head_dim -> 1


def quantize(x: torch.Tensor) -> QuantizedKV:
    """x: (..., head_dim) -> int8 values and their per-row scale."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return QuantizedKV(q.to(torch.int8), scale.to(torch.bfloat16))


def dequantize(qkv: QuantizedKV, dtype=torch.bfloat16) -> torch.Tensor:
    return (qkv.q.float() * qkv.scale.float()).to(dtype)


def quant_entry(cfg, batch: int, max_len: int, device) -> dict:
    """The cache entry of one attention block with int8 lines."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim

    def line():
        return QuantizedKV(
            q=torch.zeros((batch, max_len, kv, hd), dtype=torch.int8,
                          device=device),
            scale=torch.zeros((batch, max_len, kv, 1), dtype=torch.bfloat16,
                              device=device))

    return {"k": line(), "v": line()}


def write_row(entry_kv: QuantizedKV, bidx: torch.Tensor, slot: torch.Tensor,
              new_row: torch.Tensor, keep=None) -> QuantizedKV:
    """Quantize one (B, kv, hd) row per batch entry and store it at
    ``[bidx, slot]``, in place; returns the entry.  ``keep`` (B,) bool, if
    given, drops the rows where it is False (their slots keep their
    values)."""
    qn = quantize(new_row)
    q, scale = qn.q, qn.scale
    if keep is not None:
        q = torch.where(keep[:, None, None], q, entry_kv.q[bidx, slot])
        scale = torch.where(keep[:, None, None], scale,
                            entry_kv.scale[bidx, slot])
    entry_kv.q[bidx, slot] = q
    entry_kv.scale[bidx, slot] = scale
    return entry_kv


def read_all(entry_kv: QuantizedKV, dtype=torch.bfloat16) -> torch.Tensor:
    return dequantize(entry_kv, dtype)
