"""Dense MLPs: SwiGLU (llama/qwen), GeGLU (gemma), plain GELU.

GELU is the tanh approximation, the default of the reference's
``jax.nn.gelu`` (torch's default is the exact erf form)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense, dense_init


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def mlp_init(gen: torch.Generator, cfg: ModelConfig, d_ff: int | None = None):
    d_ff = cfg.d_ff if d_ff is None else d_ff
    d = cfg.d_model
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, d, d_ff),
            "w_up": dense_init(gen, d, d_ff),
            "w_down": dense_init(gen, d_ff, d),
        }
    return {"w_up": dense_init(gen, d, d_ff), "w_down": dense_init(gen, d_ff, d)}


def mlp(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_type in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_type == "swiglu" else gelu
        h = act(dense(params["w_gate"], x)) * dense(params["w_up"], x)
        return dense(params["w_down"], h)
    return dense(params["w_down"], gelu(dense(params["w_up"], x)))
