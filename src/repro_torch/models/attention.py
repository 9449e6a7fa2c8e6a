"""Self-attention: GQA/MQA projections with qk-norm and RoPE, the
sliding-window kernel for windowed causal blocks, a plain blocked
online-softmax ``flash_attention`` for everything else, and single-token
``decode_attention`` against KV caches.

Every ``"swa"`` block of a full-sequence pass (train mode or prefill,
positions ``arange(S)``) runs ``kernels.swa.ops.swa_attention``: on the card
the CUDA ``swa`` kernel (the reference's models call their own jnp path
instead, and its Pallas kernel only from tests).  Global, padded or
soft-capped attention takes ``flash_attention``, and a decode step
``decode_attention``: plain tensor ops as the reference computes them in
jnp, outside any Pallas kernel.  Cross-attention comes with the
encoder-decoder slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.swa.ops import swa_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    dense,
    dense_init,
    rmsnorm,
    rmsnorm_init,
    softcap,
)

NEG_INF = -1e30


def attention_init(gen: torch.Generator, cfg: ModelConfig):
    d, hd = cfg.d_model, cfg.head_dim
    p = {
        "wq": dense_init(gen, d, cfg.n_heads * hd),
        "wk": dense_init(gen, d, cfg.n_kv_heads * hd),
        "wv": dense_init(gen, d, cfg.n_kv_heads * hd),
        "wo": dense_init(gen, cfg.n_heads * hd, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, gen.device)
        p["k_norm"] = rmsnorm_init(hd, gen.device)
    return p


def _split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, head_dim)


def _qkv(params, cfg: ModelConfig, x, positions, *, rope: bool = True):
    """Project to (q, k, v), each (B, S, heads, D), with optional qk-norm
    and RoPE."""
    q = _split_heads(dense(params["wq"], x), cfg.n_heads, cfg.head_dim)
    k = _split_heads(dense(params["wk"], x), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(dense(params["wv"], x), cfg.n_kv_heads, cfg.head_dim)
    if "q_norm" in params:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def flash_attention(
    q: torch.Tensor,            # (B, Sq, H, D)
    k: torch.Tensor,            # (B, Sk, KV, D)
    v: torch.Tensor,            # (B, Sk, KV, D)
    pos_q: torch.Tensor,        # (B, Sq) absolute positions (-1 = padding)
    pos_k: torch.Tensor,        # (B, Sk)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_block: int = 512,
    kv_block: int = 512,
    attn_softcap: Optional[float] = None,
) -> torch.Tensor:
    """Blocked online-softmax attention; (q_block x kv_block) live scores.
    Scores in fp32; p rounds to v's dtype before P V, as in the reference."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Sk)
    pq = (-Sq) % q_block
    pk = (-Sk) % kv_block
    if pq:
        q = F.pad(q, (0, 0, 0, 0, 0, pq))
        pos_q = F.pad(pos_q, (0, pq), value=-1)
    if pk:
        k = F.pad(k, (0, 0, 0, 0, 0, pk))
        v = F.pad(v, (0, 0, 0, 0, 0, pk))
        pos_k = F.pad(pos_k, (0, pk), value=-1)
    scale = D ** -0.5
    outs = []
    for q0 in range(0, Sq + pq, q_block):
        qi = q[:, q0:q0 + q_block].reshape(B, q_block, KV, G, D).float()
        pqi = pos_q[:, q0:q0 + q_block]
        m = torch.full((B, q_block, KV, G), NEG_INF, device=q.device)
        l = torch.zeros((B, q_block, KV, G), device=q.device)
        acc = torch.zeros((B, q_block, KV, G, D), device=q.device)
        for k0 in range(0, Sk + pk, kv_block):
            kj = k[:, k0:k0 + kv_block].float()
            vj = v[:, k0:k0 + kv_block]
            pkj = pos_k[:, k0:k0 + kv_block]
            s = torch.einsum("bqkgd,bckd->bqkgc", qi, kj) * scale
            s = softcap(s, attn_softcap)
            valid = (pkj[:, None, :] >= 0) & (pqi[:, :, None] >= 0)
            if causal:
                valid &= pkj[:, None, :] <= pqi[:, :, None]
            if window is not None:
                valid &= pqi[:, :, None] - pkj[:, None, :] < window
            s = torch.where(valid[:, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = corr * l + p.sum(dim=-1)
            acc = corr[..., None] * acc + torch.einsum(
                "bqkgc,bckd->bqkgd", p.to(vj.dtype).float(), vj.float())
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.to(q.dtype).reshape(B, q_block, H, D))
    return torch.cat(outs, dim=1)[:, :Sq]


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor,
                     attn_softcap: Optional[float] = None) -> torch.Tensor:
    """One query token against a cache.  q: (B, 1, H, D); k_cache, v_cache:
    (B, S, KV, D), RoPE already applied to k; valid: (B, S) bool, the slots
    that hold a real key.  Scores and sums in fp32, p rounded to the
    cache's dtype before P V, as in the reference.  Returns (B, 1, H, D) in
    q's dtype."""
    B, _, H, D = q.shape
    KV = k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * D ** -0.5
    s = softcap(s, attn_softcap)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


def causal_attention(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, positions: Optional[torch.Tensor], *,
                     window: Optional[int],
                     use_kernel: bool = True) -> torch.Tensor:
    """Causal attention of (B, S, heads, D) q, k, v.  ``positions=None``
    means ``arange(S)`` for every row; a windowed block with those positions
    runs the ``swa`` kernel on (B, H, S, D) views (its plain version with
    ``use_kernel=False``), anything else ``flash_attention``."""
    b, s = q.shape[:2]
    kernel_path = window is not None and positions is None
    if kernel_path and cfg.attn_softcap is not None:
        raise NotImplementedError(
            "sliding-window attention with attn_softcap: the swa kernel has "
            "no softcap (nor has the TPU kernel), and no config sets both")
    if kernel_path:
        out = swa_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), window=window,
                            force_ref=not use_kernel)
        return out.transpose(1, 2)
    if positions is None:
        positions = torch.arange(s, device=q.device).expand(b, s)
    return flash_attention(q, k, v, positions, positions, causal=True,
                           window=window, attn_softcap=cfg.attn_softcap)


def self_attention_block(params, cfg: ModelConfig, x: torch.Tensor,
                         positions: Optional[torch.Tensor] = None, *,
                         window: Optional[int],
                         use_kernel: bool = True) -> torch.Tensor:
    """Causal self-attention (``causal_attention`` between the
    projections and ``wo``).  ``positions=None`` means ``arange(S)``."""
    return self_attention_with_kv(params, cfg, x, positions, window=window,
                                  use_kernel=use_kernel)[0]


def self_attention_with_kv(params, cfg: ModelConfig, x: torch.Tensor,
                           positions: Optional[torch.Tensor] = None, *,
                           window: Optional[int], use_kernel: bool = True):
    """``self_attention_block`` that also returns the block's k and v
    (B, S, KV, D), k after RoPE: a prefill caches them."""
    b, s, _ = x.shape
    rope_pos = (torch.arange(s, device=x.device).expand(b, s)
                if positions is None else positions)
    q, k, v = _qkv(params, cfg, x, rope_pos)
    out = causal_attention(cfg, q, k, v, positions, window=window,
                           use_kernel=use_kernel)
    return dense(params["wo"], out.reshape(b, s, -1)), k, v
