"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM (scalar
memory), both with stabilized exponential gating.

The mLSTM recurrence
    C_t = f_t C_{t-1} + i_t v_t k_t^T,   n_t = f_t n_{t-1} + i_t k_t,
    h_t = (C_t q_t) / max(|n_t^T q_t|, e^{-m_t})
is ``kernels.mlstm.ops.mlstm_chunkwise``: on the card the CUDA ``mlstm``
kernel, in the chunkwise form of the TPU kernel (the reference's model
evaluates its own jnp chunk scan instead).  Two numerical differences from
the reference's model path follow from that: q is scaled by D^-1/2 before
q k^T (the model scales after), and the gated scores and h stay fp32 (the
model rounds the scores to the compute dtype before S V and returns h in
it); h is cast to the compute dtype before the output norm.

The sLSTM has a genuine nonlinear recurrence (h_{t-1} feeds the gates
through a block-diagonal recurrent matrix), so it runs step by step in fp32:
a plain loop over S (the reference scans it with ``lax.scan``; it has no
TPU kernel).  Carried states (prefill and decode) come with the serving
slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm.ops import mlstm_chunkwise
from repro_torch.kernels.mlstm.ref import NEG
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense, dense_init, rmsnorm, rmsnorm_init
from repro_torch.models.mlp import gelu


def _no_state(state, block: str) -> None:
    if state is not None:
        raise NotImplementedError(
            f"{block} from a carried state (prefill and decode) comes with "
            f"the serving slice")


# =====================  mLSTM  =============================================

def mlstm_init(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    dm = int(cfg.mlstm_proj_factor * d)
    H = cfg.n_heads
    dev = gen.device
    return {
        "w_up": dense_init(gen, d, dm),
        "w_gate": dense_init(gen, d, dm),
        "w_q": dense_init(gen, dm, dm),
        "w_k": dense_init(gen, dm, dm),
        "w_v": dense_init(gen, dm, dm),
        "w_if": {"w": torch.randn((dm, 2 * H), generator=gen,
                                  device=dev).mul_(0.01),
                 "b": torch.cat([torch.zeros((H,), device=dev),
                                 torch.full((H,), 3.0, device=dev)])},
        "out_norm": rmsnorm_init(dm, dev),
        "w_down": dense_init(gen, dm, d),
    }


def mlstm_block(params, cfg: ModelConfig, x: torch.Tensor, state=None, *,
                use_kernel: bool = True) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d), from zero state.  ``use_kernel=False``
    runs the kernel's plain version on any device."""
    _no_state(state, "mlstm_block")
    B, S, d = x.shape
    H = cfg.n_heads
    dm = int(cfg.mlstm_proj_factor * d)
    D = dm // H
    up = dense(params["w_up"], x)
    gate = dense(params["w_gate"], x)

    def heads(t):
        return t.reshape(B, S, H, D).transpose(1, 2)              # (B, H, S, D)

    q = heads(dense(params["w_q"], up))
    k = heads(dense(params["w_k"], up))
    v = heads(dense(params["w_v"], up))
    # gate pre-activations in the compute dtype, then widened, as the
    # reference rounds them
    if_pre = (up @ params["w_if"]["w"].to(up.dtype)
              + params["w_if"]["b"].to(up.dtype))
    i_gate = if_pre[..., :H].float().transpose(1, 2)              # (B, H, S)
    log_f = F.logsigmoid(if_pre[..., H:].float()).transpose(1, 2)
    h = mlstm_chunkwise(q, k, v, log_f, i_gate, chunk=cfg.chunk_size,
                        force_ref=not use_kernel)                 # fp32
    h = h.to(x.dtype).transpose(1, 2).reshape(B, S, dm)
    h = rmsnorm(params["out_norm"], h, cfg.norm_eps)
    return dense(params["w_down"], h * F.silu(gate))


# =====================  sLSTM  =============================================

def slstm_init(gen: torch.Generator, cfg: ModelConfig):
    d = cfg.d_model
    H = cfg.n_heads
    D = d // H
    df = int(cfg.slstm_proj_factor * d)
    dev = gen.device
    bias = torch.cat([torch.zeros((D,), device=dev),
                      torch.full((D,), 3.0, device=dev),
                      torch.zeros((2 * D,), device=dev)])
    return {
        "w_x": dense_init(gen, d, 4 * d),    # i, f, z, o pre-activations
        "r": {"w": torch.randn((H, D, 4 * D), generator=gen,
                               device=dev).mul_((1.0 / D) ** 0.5)},
        "b": {"b": bias.repeat(H).reshape(H, 4 * D)},
        "out_norm": rmsnorm_init(d, dev),
        "ffn_up": dense_init(gen, d, 2 * df),
        "ffn_down": dense_init(gen, df, d),
    }


def slstm_scan(params, x_pre: torch.Tensor) -> torch.Tensor:
    """x_pre: (B, S, H, 4D) input pre-activations.  The stabilized sLSTM
    recurrence from zero state, one step at a time in fp32; returns h:
    (B, S, H, D) fp32."""
    B, S, H, D4 = x_pre.shape
    D = D4 // 4
    R = params["r"]["w"]                        # (H, D, 4D)
    b = params["b"]["b"][:, None, :]            # (H, 1, 4D)
    xs = x_pre.float().permute(1, 2, 0, 3)      # (S, H, B, 4D)
    c = torch.zeros((H, B, D), device=x_pre.device)
    n = torch.zeros_like(c)
    h = torch.zeros_like(c)
    m = torch.full_like(c, NEG)
    hs = torch.empty((S, H, B, D), device=x_pre.device)
    for t in range(S):
        pre = torch.baddbmm(xs[t], h, R) + b    # (x_t + h R) + b
        i_t, f_t, z_t, o_t = pre.split(D, dim=-1)
        fm = f_t + m
        m_new = torch.maximum(fm, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(fm - m_new)
        c = f_p * c + i_p * torch.tanh(z_t)
        n = f_p * n + i_p
        h = torch.sigmoid(o_t) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs[t] = h
    return hs.permute(2, 0, 1, 3)


def slstm_block(params, cfg: ModelConfig, x: torch.Tensor,
                state=None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d): the sLSTM from zero state, then its
    post-up GeGLU FFN (proj factor 4/3)."""
    _no_state(state, "slstm_block")
    B, S, d = x.shape
    H = cfg.n_heads
    x_pre = dense(params["w_x"], x).reshape(B, S, H, 4 * (d // H))
    h = slstm_scan(params, x_pre)
    h = rmsnorm(params["out_norm"], h.reshape(B, S, d).to(x.dtype),
                cfg.norm_eps)
    u1, u2 = dense(params["ffn_up"], h).chunk(2, dim=-1)
    return dense(params["ffn_down"], gelu(u1) * u2)
