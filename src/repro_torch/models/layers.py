"""Basic layers: dense, RMSNorm, LayerNorm, embeddings, rotary embeddings,
softcap.

Plain functions on nested dicts of tensors, as the reference's pytrees:
``*_init(gen, ...)`` draws fp32 master weights on the generator's device,
and the apply functions compute in the input's dtype, casting weights at
use (the reference's mixed-precision layout).  Dense weights keep the
reference's (d_in, d_out) orientation.
"""

from __future__ import annotations

import torch


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               scale: float | None = None):
    scale = (1.0 / d_in) ** 0.5 if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, device=gen.device)
    return {"w": w.mul_(scale)}


def dense(params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["w"].to(x.dtype)


def rmsnorm_init(d: int, device):
    return {"scale": torch.ones((d,), device=device)}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"]).to(x.dtype)


def layernorm_init(d: int, device):
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mean and population variance (``jnp.var``: ``correction=0``) in
    fp32, cast back to x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(x.dtype)


def embedding_init(gen: torch.Generator, vocab: int, d: int):
    table = torch.randn((vocab, d), generator=gen, device=gen.device)
    return {"table": table.mul_(d ** -0.5)}


def embed(params, tokens: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Rows of the table in ``dtype`` (gathered, then cast: the reference
    casts the whole table first, which gives the same values)."""
    return params["table"][tokens].to(dtype)


def unembed(params, x: torch.Tensor) -> torch.Tensor:
    """Tied read-out: logits = x @ table^T, fp32 products and sums of the
    operands in x's dtype."""
    table = params["table"].to(x.dtype).float()
    return x.float() @ table.mT


# --- rotary position embeddings -------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) absolute positions.  Rotates the
    two halves of D against each other (the reference's split layout)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)       # (D/2,)
    angles = positions[..., None].float() * freqs                 # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
