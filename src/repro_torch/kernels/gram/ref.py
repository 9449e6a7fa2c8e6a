"""Plain PyTorch versions of the Gram kernels.

These are the oracles the CPU tests hold against the JAX reference, the path
a wrapper takes for a tensor on the CPU, and what ``chip_smoke.py`` holds the
CUDA kernels against on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Kept equal to ``repro_torch.core.elm.ACTIVATIONS`` (asserted in tests):
# the fused kernel applies the same activations as the materialized path.
# gelu is the tanh approximation, the default of the reference's gelu.
ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def gram_ref(H: torch.Tensor, T: torch.Tensor):
    """H: (..., N, L); T: (..., N, D).  Returns (G = H^T H, R = H^T T) in
    fp32, batched over any leading agent axes."""
    Hf = H.float()
    return Hf.mT @ Hf, Hf.mT @ T.float()


def gram_fused_ref(X, W, b, T, activation: str = "sigmoid",
                   precision: str = "fp32"):
    """Materialized version of the fused producer: ``H = act(X W + b)``,
    then :func:`gram_ref`.  bf16 rounds H and T to bf16 first, like the
    materialized bf16 stream."""
    H = ACTIVATIONS[activation](X.float() @ W.float() + b.float())
    if precision == "bf16":
        H, T = H.bfloat16(), T.bfloat16()
    return gram_ref(H, T)
