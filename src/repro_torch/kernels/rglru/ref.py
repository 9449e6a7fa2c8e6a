"""Plain PyTorch version of the RG-LRU scan kernel: a loop over time.

The CPU tests hold it against the reference's ``rglru_scan_ref`` and
``rglru_scan``; ``chip_smoke.py`` holds the CUDA kernel against it on the
card.
"""

from __future__ import annotations

import torch


def rglru_scan_ref(log_a: torch.Tensor, b: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """h_t = exp(log_a_t) * h_{t-1} + b_t from h_{-1} = h0.

    log_a, b: (B, S, D); h0: (B, D).  Returns h: (B, S, D) fp32."""
    a = torch.exp(log_a.float())
    bf = b.float()
    h = h0.float()
    out = torch.empty_like(bf)
    for t in range(a.shape[1]):
        h = a[:, t] * h + bf[:, t]
        out[:, t] = h
    return out
