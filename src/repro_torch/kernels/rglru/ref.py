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
    h = h0.float()
    # the inputs are unbound and the steps stacked, not indexed and written
    # into a buffer: under autograd an index's or a slice assignment's
    # backward moves the whole (B, S, D) gradient at every step, unbind
    # and stack move it once
    hs = []
    for a_t, b_t in zip(torch.exp(log_a.float()).unbind(1),
                        b.float().unbind(1)):
        h = a_t * h + b_t
        hs.append(h)
    return torch.stack(hs, dim=1)
