"""The assigned input shapes, and every model input of an (arch, shape)
pair as a tensor on the meta device (shape and dtype, no storage): the
stand-in for the reference's ``jax.ShapeDtypeStruct``.

  train_4k     seq=4096    global_batch=256   -> train_step
  prefill_32k  seq=32768   global_batch=32    -> prefill (prompt ingest)
  decode_32k   seq=32768   global_batch=128   -> decode_step (1 token + cache)
  long_500k    seq=524288  global_batch=1     -> decode_step, sub-quadratic only

``long_500k`` swaps sliding-window attention in for full-attention blocks
(``variant_for_shape``); training turns on remat.  VLM prefix patches count
toward the sequence in train and prefill; audio encoder frames are extra
encoder-side inputs.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models.cache import init_cache
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str          # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}


def variant_for_shape(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """``long_500k`` needs sub-quadratic attention: every ``attn`` block
    becomes ``swa`` with a 4096 window (xlstm, recurrentgemma and danube's
    sliding windows are unchanged).  Training turns on remat."""
    overrides = {}
    if shape.name == "long_500k" and "attn" in cfg.block_pattern:
        overrides["block_pattern"] = tuple(
            "swa" if k == "attn" else k for k in cfg.block_pattern)
        overrides["sliding_window"] = 4096
    if shape.kind == "train":
        overrides["remat"] = True
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    """Meta-device stand-ins for every model input (nothing allocated):
    train {tokens, labels} (+ prefix_embeds or enc_embeds), prefill
    {tokens} (+ the same), decode {tokens (B, 1), cache}: the
    ``init_cache`` tree of S slots, bf16 lines, on the meta device."""
    B, S = shape.batch, shape.seq
    act_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    if shape.kind in ("train", "prefill"):
        s_text = S
        batch: Dict[str, Any] = {}
        if cfg.family == "vlm":
            p = cfg.n_prefix_embeddings
            s_text = S - p
            batch["prefix_embeds"] = _meta((B, p, cfg.d_model), act_dtype)
        if cfg.family == "audio":
            batch["enc_embeds"] = _meta((B, cfg.enc_seq, cfg.d_model),
                                        act_dtype)
        batch["tokens"] = _meta((B, s_text), torch.int32)
        if shape.kind == "train":
            batch["labels"] = _meta((B, s_text), torch.int32)
        return batch
    # decode: ONE new token and a cache of S positions
    return {"tokens": _meta((B, 1), torch.int32),
            "cache": init_cache(cfg, B, S, torch.bfloat16, device="meta")}
