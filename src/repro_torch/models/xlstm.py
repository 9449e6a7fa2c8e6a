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
TPU kernel).

Both blocks run from a carried state and return the state after their last
step (``MLSTMState``, ``SLSTMState``, fp32), for prefill and decode.  The
mLSTM's kernel, like the TPU kernel, starts from zero state and returns h
only: a prefill takes h from the kernel and its final (C, n, m) from one
plain fp32 pass over the sequence (``_mlstm_final_state``), and a block from
a carried state (each decode step) runs ``mlstm_chunkwise_ref`` from it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.mlstm.ops import mlstm_chunkwise
from repro_torch.kernels.mlstm.ref import NEG, mlstm_chunkwise_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense, dense_init, rmsnorm, rmsnorm_init
from repro_torch.models.mlp import gelu


def _check_state(state, kind: type, block: str) -> None:
    if state is not None and not isinstance(state, kind):
        raise TypeError(f"{block} takes a {kind.__name__} or None, got "
                        f"{type(state).__name__}")


# =====================  mLSTM  =============================================

class MLSTMState(NamedTuple):
    C: torch.Tensor   # (B, H, D, D) matrix memory, fp32
    n: torch.Tensor   # (B, H, D)    normalizer
    m: torch.Tensor   # (B, H)       stabilizer (log space)


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


def _mlstm_final_state(k: torch.Tensor, v: torch.Tensor, log_f: torch.Tensor,
                       i_gate: torch.Tensor) -> MLSTMState:
    """The state after S steps from zero state, in one fp32 pass:
    m = max_j (i_j + s_j), with s_j the sum of log_f over the steps after j
    (a reverse cumulative sum: at S = 4096 the difference A_S - A_j of
    forward sums would cancel), and C = sum_j e^{i_j + s_j - m} v_j k_j^T,
    n likewise with k_j.  k, v: (B, H, S, D); log_f, i_gate: (B, H, S)."""
    f = log_f.float()
    after = torch.flip(torch.cumsum(torch.flip(f, (-1,)), -1), (-1,))
    s = F.pad(after[..., 1:], (0, 1))               # sum of log_f after j
    a = i_gate.float() + s
    m = a.amax(dim=-1)
    w = torch.exp(a - m[..., None])                  # (B, H, S)
    kf = k.float()
    C = (v.float() * w[..., None]).mT @ kf          # (B, H, D, D), v-major
    n = (w[..., None, :] @ kf)[..., 0, :]
    return MLSTMState(C=C, n=n, m=m)


def mlstm_inputs(params, cfg: ModelConfig, x: torch.Tensor):
    """The mLSTM's inputs from x (B, S, d): q, k, v (B, H, S, D) in x's
    dtype, log_f and i_gate (B, H, S) fp32, and the output gate's
    pre-activation (B, S, dm)."""
    B, S, d = x.shape
    H = cfg.n_heads
    D = int(cfg.mlstm_proj_factor * d) // H
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
    return q, k, v, log_f, i_gate, gate


def mlstm_block(params, cfg: ModelConfig, x: torch.Tensor, state=None, *,
                use_kernel: bool = True, final_state: bool = False):
    """x: (B, S, d).  Returns (out (B, S, d), the MLSTMState after the last
    step, or None).

    From zero state (``state=None``) h comes from the ``mlstm`` kernel (its
    plain version with ``use_kernel=False``), and the final state, asked
    for with ``final_state=True``, from ``_mlstm_final_state``.  From a
    carried state the whole block runs ``mlstm_chunkwise_ref`` from it and
    returns the new state."""
    _check_state(state, MLSTMState, "mlstm_block")
    B, S, d = x.shape
    dm = int(cfg.mlstm_proj_factor * d)
    q, k, v, log_f, i_gate, gate = mlstm_inputs(params, cfg, x)
    new_state = None
    if state is None:
        h = mlstm_chunkwise(q, k, v, log_f, i_gate, chunk=cfg.chunk_size,
                            force_ref=not use_kernel)             # fp32
        if final_state:
            new_state = _mlstm_final_state(k, v, log_f, i_gate)
    else:
        h, (C, n, m) = mlstm_chunkwise_ref(
            q, k, v, log_f, i_gate, cfg.chunk_size, C0=state.C, n0=state.n,
            m0=state.m, final_state=True)
        new_state = MLSTMState(C=C, n=n, m=m)
    h = h.to(x.dtype).transpose(1, 2).reshape(B, S, dm)
    h = rmsnorm(params["out_norm"], h, cfg.norm_eps)
    return dense(params["w_down"], h * F.silu(gate)), new_state


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


class SLSTMState(NamedTuple):
    c: torch.Tensor   # (B, H, D) cell, fp32
    n: torch.Tensor   # (B, H, D) normalizer
    h: torch.Tensor   # (B, H, D) hidden (feeds back)
    m: torch.Tensor   # (B, H, D) stabilizer


def slstm_scan(params, x_pre: torch.Tensor, state=None):
    """x_pre: (B, S, H, 4D) input pre-activations; ``state``: the
    SLSTMState before them, or None for zero state.  The stabilized sLSTM
    recurrence one step at a time in fp32; returns (h (B, S, H, D) fp32,
    the SLSTMState after the last step)."""
    B, S, H, D4 = x_pre.shape
    D = D4 // 4
    R = params["r"]["w"]                        # (H, D, 4D)
    b = params["b"]["b"][:, None, :]            # (H, 1, 4D)
    xs = x_pre.float().permute(1, 2, 0, 3)      # (S, H, B, 4D)
    if state is None:
        c = torch.zeros((H, B, D), device=x_pre.device)
        n = torch.zeros_like(c)
        h = torch.zeros_like(c)
        m = torch.full_like(c, NEG)
    else:                                       # (B, H, D) -> (H, B, D)
        c, n, h, m = (t.float().transpose(0, 1) for t in state)
    # the inputs unbound and the outputs stacked: autograd moves the
    # (S, ...) gradients once, not at every step
    hs = []
    for x_t in xs.unbind(0):
        pre = torch.baddbmm(x_t, h, R) + b      # (x_t + h R) + b
        i_t, f_t, z_t, o_t = pre.split(D, dim=-1)
        fm = f_t + m
        m_new = torch.maximum(fm, i_t)
        i_p = torch.exp(i_t - m_new)
        f_p = torch.exp(fm - m_new)
        c = f_p * c + i_p * torch.tanh(z_t)
        n = f_p * n + i_p
        h = torch.sigmoid(o_t) * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    final = SLSTMState(*(t.transpose(0, 1).contiguous() for t in (c, n, h, m)))
    return torch.stack(hs).permute(2, 0, 1, 3), final


def slstm_block(params, cfg: ModelConfig, x: torch.Tensor, state=None):
    """x: (B, S, d): the sLSTM from ``state`` (None for zero state), then
    its post-up GeGLU FFN (proj factor 4/3).  Returns (out (B, S, d), the
    SLSTMState after the last step)."""
    _check_state(state, SLSTMState, "slstm_block")
    B, S, d = x.shape
    H = cfg.n_heads
    x_pre = dense(params["w_x"], x).reshape(B, S, H, 4 * (d // H))
    h, new_state = slstm_scan(params, x_pre, state)
    h = rmsnorm(params["out_norm"], h.reshape(B, S, d).to(x.dtype),
                cfg.norm_eps)
    u1, u2 = dense(params["ffn_up"], h).chunk(2, dim=-1)
    return dense(params["ffn_down"], gelu(u1) * u2), new_state
