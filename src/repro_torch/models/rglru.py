"""Griffin / RecurrentGemma recurrent block (arXiv:2402.19427).

Structure per block:  x -> [gate branch: Dense -> GeLU]
                        -> [rnn branch: Dense -> causal Conv1D(w=4) -> RG-LRU]
                      out = Dense(gate * rnn)

RG-LRU:  r_t = sigmoid(W_r u_t + b_r)          (recurrence gate)
         i_t = sigmoid(W_i u_t + b_i)          (input gate)
         log a_t = -c * softplus(Lambda) * r_t (per-channel decay, log space)
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The gates and coefficients are elementwise torch; the recurrence itself is
``kernels.rglru.ops.rglru_scan``: on the card the CUDA ``rglru`` kernel (the
reference's model evaluates it with ``associative_scan`` instead).  Decode
with carried state comes with the serving slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru.ops import rglru_scan
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense, dense_init
from repro_torch.models.mlp import gelu


class RGLRUState(NamedTuple):
    h: torch.Tensor       # (B, d_rnn) recurrent state
    conv: torch.Tensor    # (B, w-1, d_rnn) trailing conv inputs


def rglru_init(gen: torch.Generator, cfg: ModelConfig):
    d, dr, w = cfg.d_model, cfg.d_rnn, cfg.conv1d_width
    dev = gen.device
    # Lambda uniform on (0, 1), so that a = exp(-c softplus(Lambda)) spans
    # ~(0.9, 0.999) at c = 8, as the reference draws it
    lam = torch.rand((dr,), generator=gen, device=dev)
    return {
        "w_gate": dense_init(gen, d, dr),
        "w_rnn": dense_init(gen, d, dr),
        "conv": {"w": torch.randn((w, dr), generator=gen, device=dev).mul_(0.1),
                 "b": torch.zeros((dr,), device=dev)},
        "w_r": dense_init(gen, dr, dr),
        "w_i": dense_init(gen, dr, dr),
        "b_r": {"b": torch.zeros((dr,), device=dev)},
        "b_i": {"b": torch.zeros((dr,), device=dev)},
        "lam": {"lam": lam},
        "w_out": dense_init(gen, dr, d),
    }


def _causal_conv1d(params, x: torch.Tensor):
    """Depthwise causal conv from a zero history.  x: (B, S, D).  Returns
    (out, the last w - 1 inputs)."""
    w = params["w"].shape[0]
    S = x.shape[1]
    x_pad = F.pad(x, (0, 0, w - 1, 0))
    out = torch.zeros_like(x)
    for i in range(w):
        out = out + x_pad[:, i:i + S] * params["w"][i].to(x.dtype)
    out = out + params["b"].to(x.dtype)
    return out, x_pad[:, x_pad.shape[1] - (w - 1):]


def _rglru_scan(u, r, i, lam, c: float, h0, use_kernel: bool = True):
    """u, r, i: (B, S, D) fp32; lam: (D,); h0: (B, D).  The coefficients of
    h_t = a_t h_{t-1} + b_t in fp32, then the scan kernel from h0 (its plain
    version with ``use_kernel=False``; the reference folds h0 into b_0
    instead, the same value)."""
    log_a = -c * F.softplus(lam) * r                       # (B, S, D) <= 0
    beta = torch.sqrt(-torch.expm1(2.0 * log_a))           # sqrt(1 - a^2)
    b = beta * (i * u)
    return rglru_scan(log_a, b, h0, force_ref=not use_kernel)


def rglru_block(params, cfg: ModelConfig, x: torch.Tensor, state=None, *,
                use_kernel: bool = True):
    """x: (B, S, d).  Returns (out, RGLRUState at the last step)."""
    if state is not None:
        raise NotImplementedError(
            "rglru_block from a carried state (decode) comes with the "
            "serving slice")
    B = x.shape[0]
    gate = gelu(dense(params["w_gate"], x))
    u = dense(params["w_rnn"], x)
    u, conv_state = _causal_conv1d(params["conv"], u)
    uf = u.float()
    r = torch.sigmoid(dense(params["w_r"], uf) + params["b_r"]["b"])
    i = torch.sigmoid(dense(params["w_i"], uf) + params["b_i"]["b"])
    h0 = torch.zeros((B, cfg.d_rnn), device=x.device)
    h = _rglru_scan(uf, r, i, params["lam"]["lam"], cfg.rglru_c, h0,
                    use_kernel)
    out = dense(params["w_out"], h.to(x.dtype) * gate)
    return out, RGLRUState(h=h[:, -1], conv=conv_state)
