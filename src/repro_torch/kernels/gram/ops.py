"""Public Gram ops: precision casting and the choice between the CUDA
kernels and their plain versions.

``gram``         one agent, (N, L); runs the agent-batched kernel with a
                 singleton agent axis.
``gram_batched`` (m, N, L): statistics of all m agents in ONE launch of the
                 triangular kernel, which writes the full symmetric G.
``gram_fused``   statistics straight from raw (X, W, b, T): the hidden layer
                 ``H = act(X W + b)`` is computed inside the kernel.

``force_ref=True`` takes the plain version on any device.  Otherwise a CUDA
tensor launches the kernel (or raises) and a CPU tensor takes the plain
version.  The kernels mask ragged N and L themselves, so nothing is padded
here.

Precision: ``"fp32"`` is IEEE fp32 throughout.  ``"bf16"`` casts H and T to
bf16 once at the op boundary and accumulates in fp32: G/R carry a relative
error of order 2^-8 of the accumulated magnitude (test tolerance 3e-2).
``"int8"`` and ``variant="dense"`` are the int8 and dense-baseline kernels,
which belong to the next port slice.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.gram import kernel
from repro_torch.kernels.gram.ref import gram_fused_ref, gram_ref

PRECISIONS = ("fp32", "bf16", "int8")
FUSED_PRECISIONS = ("fp32", "bf16")


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {PRECISIONS}"
        )
    if precision == "int8":
        raise NotImplementedError(
            "precision='int8' (the int8 Gram kernel) is not ported yet: "
            "it belongs to port slice 2"
        )


def _cast(H: torch.Tensor, T: torch.Tensor, precision: str):
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    return H.to(dtype), T.to(dtype)


def gram_batched(H: torch.Tensor, T: torch.Tensor, *, force_ref: bool = False,
                 precision: str = "fp32"):
    """Per-agent (H^T H, H^T T) for all m agents.  H: (m, N, L),
    T: (m, N, D).  Returns (G (m, L, L), R (m, L, D)), both fp32."""
    _check_precision(precision)
    H, T = _cast(H, T, precision)
    if force_ref:
        return gram_ref(H, T)
    return kernel.gram_tri(H.contiguous(), T.contiguous())


def gram(H: torch.Tensor, T: torch.Tensor, *, force_ref: bool = False,
         variant: str = "tri", precision: str = "fp32"):
    """(H^T H, H^T T) for one agent.  H: (N, L), T: (N, D)."""
    if variant == "dense":
        raise NotImplementedError(
            "variant='dense' (the dense-tile baseline kernel) is not ported "
            "yet: it belongs to port slice 2"
        )
    if variant != "tri":
        raise ValueError(f"unknown variant {variant!r}; 'tri' or 'dense'")
    G, R = gram_batched(H[None], T[None], force_ref=force_ref,
                        precision=precision)
    return G[0], R[0]


def gram_fused(X: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
               T: torch.Tensor, *, activation: str = "sigmoid",
               force_ref: bool = False, precision: str = "fp32"):
    """Statistics of ``H = act(X W + b)`` without materializing H.

    X: (m, N, d_in) or (N, d_in); W: (d_in, L); b: (L,); T matches X's
    leading shape with trailing D.  Returns (G, R) like ``gram_batched`` on
    the materialized H.  ``precision="bf16"`` rounds the hidden tiles and T
    to bf16 before the products."""
    if precision not in FUSED_PRECISIONS:
        raise ValueError(
            f"fused precision must be one of {FUSED_PRECISIONS}, got "
            f"{precision!r} (int8 needs a materialized maxabs pass)"
        )
    batched = X.ndim == 3
    if not batched:
        X, T = X[None], T[None]
    if force_ref:
        G, R = gram_fused_ref(X, W, b, T, activation, precision)
    else:
        t_dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        G, R = kernel.gram_fused(
            X.float().contiguous(), W.float().contiguous(),
            b.float().reshape(-1).contiguous(), T.to(t_dtype).contiguous(),
            activation=activation, precision=precision,
        )
    return (G, R) if batched else (G[0], R[0])
