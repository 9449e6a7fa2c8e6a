"""Plain PyTorch versions of the chunkwise mLSTM kernel.

``mlstm_sequential_ref`` is the step-by-step stabilized recurrence, the
oracle of both chunkwise forms.  ``mlstm_chunkwise_ref`` is the chunk
algebra of the TPU kernel (``repro/kernels/mlstm/kernel.py``) as a loop over
chunks: the tests and the ``use_kernel=False`` path use it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.  With
``operand_terms`` it models the CUDA kernel's bf16 body, whose two D x D
products take their fp32 operand (C, and w v) on the tensor cores as a sum
of bf16 terms; only the tests call it so.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30     # the stabilizer's start, and the input gate of a padding step


def mlstm_sequential_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         log_f: torch.Tensor,
                         i_gate: torch.Tensor) -> torch.Tensor:
    """q, k, v: (B, H, S, D); log_f (log-sigmoid forget), i_gate: (B, H, S).

    Stabilized matrix-memory recurrence from zero state:
      m_t = max(m_{t-1} + log_f_t, i_t)
      C_t = e^{m_{t-1}+log_f_t-m_t} C_{t-1} + e^{i_t-m_t} v_t k_t^T
      n_t likewise with k_t
      h_t = C_t q~_t / max(|n_t^T q~_t|, e^{-m_t}),  q~ = q / sqrt(D)
    Returns h: (B, H, S, D) fp32."""
    B, H, S, D = q.shape
    qf = q.float() * D ** -0.5
    kf, vf = k.float(), v.float()
    f, ig = log_f.float(), i_gate.float()
    C = torch.zeros((B, H, D, D), device=q.device)
    n = torch.zeros((B, H, D), device=q.device)
    m = torch.full((B, H), NEG, device=q.device)
    out = torch.empty((B, H, S, D), device=q.device)
    for t in range(S):
        m_new = torch.maximum(m + f[..., t], ig[..., t])
        fp = torch.exp(m + f[..., t] - m_new)
        ip = torch.exp(ig[..., t] - m_new)
        C = (fp[..., None, None] * C
             + ip[..., None, None] * (vf[:, :, t, :, None] * kf[:, :, t, None, :]))
        n = fp[..., None] * n + ip[..., None] * kf[:, :, t]
        num = torch.einsum("bhde,bhe->bhd", C, qf[:, :, t])
        den = torch.einsum("bhd,bhd->bh", n, qf[:, :, t])
        out[:, :, t] = num / torch.maximum(den.abs(),
                                           torch.exp(-m_new))[..., None]
        m = m_new
    return out


def bf16_terms(x: torch.Tensor, n: int) -> torch.Tensor:
    """x as the sum of its first ``n`` bf16 terms, in fp32: t_0 = bf16(x),
    t_1 = bf16(x - t_0), ... (the split of the CUDA kernel's bf16 body)."""
    total = torch.zeros_like(x)
    rest = x
    for _ in range(n):
        term = rest.bfloat16().float()
        total = total + term
        rest = rest - term
    return total


def mlstm_chunkwise_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        log_f: torch.Tensor, i_gate: torch.Tensor,
                        chunk: int,
                        operand_terms: int | None = None) -> torch.Tensor:
    """The same function in the TPU kernel's chunkwise form, from zero
    state.  Inputs are widened to fp32 and q is scaled by D^-1/2 before
    q k^T.  A ragged S is padded with identity steps (log_f = 0, i = -1e30)
    whose outputs are dropped.  Returns h: (B, H, S, D) fp32.

    ``operand_terms=n`` replaces the fp32 operand of the two D x D products,
    the carried state C in q C^T and w v in the state update, by the sum of
    its first n bf16 terms (``bf16_terms``), as the CUDA kernel's bf16 body
    multiplies them; the scores, S V and the denominator stay fp32.
    ``None`` (the default) is the plain fp32 algebra."""
    split = ((lambda x: x) if operand_terms is None
             else (lambda x: bf16_terms(x, operand_terms)))
    B, H, S, D = q.shape
    c = min(chunk, S)
    pad = (-S) % c
    qf = q.float() * D ** -0.5
    kf, vf = k.float(), v.float()
    f, ig = log_f.float(), i_gate.float()
    if pad:
        qf, kf, vf = (F.pad(x, (0, 0, 0, pad)) for x in (qf, kf, vf))
        f = F.pad(f, (0, pad))
        ig = F.pad(ig, (0, pad), value=NEG)
    dev = q.device
    C = torch.zeros((B, H, D, D), device=dev)
    n = torch.zeros((B, H, D), device=dev)
    m_prev = torch.full((B, H), NEG, device=dev)
    causal = torch.ones((c, c), dtype=torch.bool, device=dev).tril()
    out = torch.empty((B, H, S + pad, D), device=dev)
    for t0 in range(0, S + pad, c):
        qc, kc, vc = (x[:, :, t0:t0 + c] for x in (qf, kf, vf))
        fc, ic = f[..., t0:t0 + c], ig[..., t0:t0 + c]
        A = torch.cumsum(fc, dim=-1)                       # (B, H, c)
        gmax = torch.cummax(ic - A, dim=-1).values
        m_i = A + torch.maximum(m_prev[..., None], gmax)
        # intra-chunk: exp(logw) may overflow above the diagonal; the
        # where selects 0 there, as the reference does
        logw = (A[..., :, None] - A[..., None, :] + ic[..., None, :]
                - m_i[..., :, None])
        Sij = (qc @ kc.mT) * torch.where(causal, torch.exp(logw), 0.0)
        num = Sij @ vc
        den = Sij.sum(dim=-1)
        # inter-chunk, from the carried state
        decay_q = torch.exp(m_prev[..., None] + A - m_i)
        num = num + decay_q[..., None] * (qc @ split(C).mT)
        den = den + decay_q * (qc @ n[..., None])[..., 0]
        out[:, :, t0:t0 + c] = num / torch.maximum(
            den.abs(), torch.exp(-m_i))[..., None]
        # the state at the chunk's end
        A_c, m_new = A[..., -1], m_i[..., -1]
        w = torch.exp(A_c[..., None] - A + ic - m_new[..., None])
        decay_C = torch.exp(m_prev + A_c - m_new)
        C = decay_C[..., None, None] * C + split(vc * w[..., None]).mT @ kc
        n = decay_C[..., None] * n + (w[..., None, :] @ kc)[..., 0, :]
        m_prev = m_new
    return out[:, :, :S]
