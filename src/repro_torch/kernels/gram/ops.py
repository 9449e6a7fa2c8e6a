"""Public Gram ops: precision casting, int8 tile quantization, and the choice
between the CUDA kernels and their plain versions.

``gram``         one agent, (N, L); runs the agent-batched kernel with a
                 singleton agent axis (``variant="dense"``: the dense-tile
                 baseline kernel instead).
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
``"int8"`` (triangular only) quantizes H per (block_n, block_l) tile with a
maxabs/127 scale and stochastic rounding seeded by ``quant_seed`` (see
``ref.quantize_tiles``), then runs the int8 kernel with exact int32 tile
sums; T streams in bf16.  ``force_ref=True`` runs the emulation
(quantize, dequantize, fp32 products) on the same draws.

``block_l`` / ``block_n``: the reference's keywords.  For fp32 and bf16 they
are tiling hints that the CUDA kernels ignore (their tile is fixed); for
int8 they define the quantization tiles and so the result.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.gram import kernel
from repro_torch.kernels.gram.ref import (
    gram_fused_ref,
    gram_ref,
    int8_emulated_ref,
    quant_generator,
    quantize_dequantize,
    quantize_tiles,
)

PRECISIONS = ("fp32", "bf16", "int8")
FUSED_PRECISIONS = ("fp32", "bf16")


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def resolve_block_n(N: int, block_n: int) -> int:
    """The reference's block policy: clamp to the sample count rounded up
    to 8, then round up to a multiple of 8."""
    return _round_up(max(8, min(block_n, _round_up(N, 8))), 8)


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {PRECISIONS}"
        )


def _cast(H: torch.Tensor, T: torch.Tensor, precision: str):
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    return H.to(dtype), T.to(dtype)


def gram_batched(H: torch.Tensor, T: torch.Tensor, *, block_l: int = 128,
                 block_n: int = 512, force_ref: bool = False,
                 precision: str = "fp32", quant_seed: int = 0):
    """Per-agent (H^T H, H^T T) for all m agents.  H: (m, N, L),
    T: (m, N, D).  Returns (G (m, L, L), R (m, L, D)), both fp32."""
    _check_precision(precision)
    if precision == "int8":
        bn = resolve_block_n(H.shape[1], block_n)
        if force_ref:
            Hdq = quantize_dequantize(H, block_l=block_l, block_n=bn,
                                      quant_seed=quant_seed)
            return int8_emulated_ref(Hdq, T)
        Hq, scales = quantize_tiles(H, bn, block_l,
                                    quant_generator(quant_seed, H.device))
        return kernel.gram_tri_q(Hq, scales, T.bfloat16().contiguous(),
                                 block_n=bn, block_l=block_l)
    H, T = _cast(H, T, precision)
    if force_ref:
        return gram_ref(H, T)
    return kernel.gram_tri(H.contiguous(), T.contiguous())


def gram(H: torch.Tensor, T: torch.Tensor, *, block_l: int = 128,
         block_n: int = 512, force_ref: bool = False, variant: str = "tri",
         precision: str = "fp32", quant_seed: int = 0):
    """(H^T H, H^T T) for one agent.  H: (N, L), T: (N, D).

    ``variant="dense"`` runs the dense-tile baseline kernel (fp32/bf16);
    ``precision="int8"`` is triangular only."""
    _check_precision(precision)
    if variant not in ("tri", "dense"):
        raise ValueError(f"unknown variant {variant!r}; 'tri' or 'dense'")
    if variant == "dense":
        if precision == "int8":
            raise ValueError(
                "precision='int8' requires variant='tri' (the dense "
                "baseline has no int8 path)"
            )
        H, T = _cast(H, T, precision)
        if force_ref:
            return gram_ref(H, T)
        return kernel.gram_dense(H.contiguous(), T.contiguous())
    G, R = gram_batched(H[None], T[None], block_l=block_l, block_n=block_n,
                        force_ref=force_ref, precision=precision,
                        quant_seed=quant_seed)
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
