"""Public RG-LRU scan op: the choice between the CUDA kernel and its plain
version.

``force_ref=True`` takes the plain version on any device.  Otherwise a CUDA
tensor launches the kernel (or raises) and a CPU tensor takes the plain
version.  The kernel walks any S and masks any D, so nothing is padded
(the reference pads to its blocks with identity steps and dead channels).
Forward-only, like the TPU kernel: an input that requires grad raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._common import forward_only
from repro_torch.kernels.rglru import kernel
from repro_torch.kernels.rglru.ref import rglru_scan_ref


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, *,
               force_ref: bool = False) -> torch.Tensor:
    """h_t = exp(log_a_t) h_{t-1} + b_t over axis 1.  log_a, b: (B, S, D);
    h0: (B, D).  Returns (B, S, D) fp32."""
    forward_only("rglru_scan", log_a, b, h0)
    if force_ref:
        return rglru_scan_ref(log_a, b, h0)
    return kernel.rglru(log_a.float().contiguous(), b.float().contiguous(),
                        h0.float().contiguous())
