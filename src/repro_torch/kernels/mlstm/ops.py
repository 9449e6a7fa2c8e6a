"""Public chunkwise-mLSTM op: the choice between the CUDA kernel and its
plain version.

``force_ref=True`` takes the plain version (the chunkwise algebra in
PyTorch) on any device.  Otherwise a CUDA tensor launches the kernel (or
raises) and a CPU tensor takes the plain version.  The kernel masks a ragged
S itself, so nothing is padded (the reference pads S to its chunk with
identity steps).  Forward-only, like the TPU kernel: an input that requires
grad raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._common import forward_only
from repro_torch.kernels.mlstm import kernel
from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_f: torch.Tensor, i_gate: torch.Tensor, *,
                    chunk: int = 64, force_ref: bool = False) -> torch.Tensor:
    """q, k, v: (B, H, S, D); log_f, i_gate: (B, H, S).  The stabilized
    mLSTM from zero state; returns h: (B, H, S, D) fp32."""
    forward_only("mlstm_chunkwise", q, k, v, log_f, i_gate)
    if force_ref:
        return mlstm_chunkwise_ref(q, k, v, log_f, i_gate, chunk)
    return kernel.mlstm(q.contiguous(), k.contiguous(), v.contiguous(),
                        log_f.float().contiguous(),
                        i_gate.float().contiguous(), chunk)
