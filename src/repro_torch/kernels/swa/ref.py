"""Plain PyTorch version of the sliding-window attention kernel: the full
masked softmax over all S keys, in fp32.

The CPU tests hold it against the reference's ``swa_ref`` and
``swa_attention``; ``chip_smoke.py`` holds the CUDA kernel against it on the
card.  Its scores are (B, H, S, S) fp32, so it is for checks, not for long
sequences on the main path.
"""

from __future__ import annotations

import torch


def swa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            window: int) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, KV, S, D), H a multiple of KV (query head
    h reads kv head h // (H // KV)).  Causal sliding window: query i attends
    key j iff ``j <= i`` and ``i - j < window``.  Returns (B, H, S, D) in
    q's dtype; scores, softmax and P V in fp32, the scale ``D ** -0.5``
    applied after Q K^T."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.float().reshape(B, KV, G, S, D)
    s = torch.einsum("bkgid,bkjd->bkgij", qg, k.float()) * (D ** -0.5)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    s.masked_fill_(~((j <= i) & (i - j < window)), float("-inf"))
    p = torch.softmax(s, dim=-1)
    del s
    out = torch.einsum("bkgij,bkjd->bkgid", p, v.float())
    return out.reshape(B, H, S, D).to(q.dtype)
