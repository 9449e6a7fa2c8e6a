"""Public sliding-window attention op: the choice between the CUDA kernel
and its plain version.

``force_ref=True`` takes the plain version on any device.  Otherwise a CUDA
tensor launches the kernel (or raises) and a CPU tensor takes the plain
version.  The kernel masks a ragged S itself, so nothing is padded (the
reference pads S to its query block).  The op is forward-only, like the TPU
kernel: an input that requires grad raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._common import forward_only
from repro_torch.kernels.swa import kernel
from repro_torch.kernels.swa.ref import swa_ref


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int, force_ref: bool = False) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, KV, S, D).  Causal sliding-window
    attention; returns (B, H, S, D) in q's dtype."""
    forward_only("swa_attention", q, k, v)
    if force_ref:
        return swa_ref(q, k, v, window)
    return kernel.swa(q.contiguous(), k.contiguous(), v.contiguous(), window)
