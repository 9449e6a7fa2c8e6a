"""Plain PyTorch versions of the Gram kernels, and the int8 quantizer.

These are the oracles the CPU tests hold against the JAX reference, the path
a wrapper takes for a tensor on the CPU, and what ``chip_smoke.py`` holds the
CUDA kernels against on the card.

int8 quantization (the reference's ``ops.quantize_tiles``): H is cut into
(block_n rows x block_l columns) tiles, each with one fp32 scale
``max(maxabs, 1e-30) / 127``, and entries round stochastically,
``q = clip(floor(x / scale + u), -127, 127)`` with u ~ U[0, 1), so that
E[q * scale] = x.  The tiles are laid out as the reference pads them (zero
rows and columns up to block multiples); zeros never raise a tile's maxabs
and always round to 0, so the scales and the true entries are the same as
without padding.
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


# int32 tile sums convert to fp32 exactly while |sum| <= 2^24; a sum of
# block_n products of two int8 values in [-127, 127] stays there for
# block_n <= 2^24 / 127^2.
MAX_INT8_BLOCK_N = 2**24 // 127**2


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


def _tiles(H: torch.Tensor, block_n: int, block_l: int):
    """H (m, N, L) -> (x, scales): x = H / scale in the zero-padded tile
    layout (m, nn, block_n, nl, block_l), scales (m, nn, nl) fp32."""
    m, N, L = H.shape
    Hp = F.pad(H.float(), (0, (-L) % block_l, 0, (-N) % block_n))
    nn, nl = Hp.shape[1] // block_n, Hp.shape[2] // block_l
    tiles = Hp.reshape(m, nn, block_n, nl, block_l)
    scales = torch.clamp_min(tiles.abs().amax(dim=(2, 4)), 1e-30) / 127.0
    return tiles / scales[:, :, None, :, None], scales


def _round_tiles(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding for given uniforms u in [0, 1).  The clip is
    needed: x = maxabs / scale can round to 127.00001."""
    return torch.clamp(torch.floor(x + u), -127, 127).to(torch.int8)


def quantize_tiles(H: torch.Tensor, block_n: int, block_l: int,
                   generator: torch.Generator):
    """Per-tile symmetric int8 quantization with stochastic rounding.

    H: (m, N, L), any N and L.  ``u`` is drawn from ``generator`` (a
    ``torch.Generator`` on H's device) in the padded tile layout.  Returns
    (Hq (m, N, L) int8, scales (m, ceil(N / block_n), ceil(L / block_l))
    fp32)."""
    m, N, L = H.shape
    x, scales = _tiles(H, block_n, block_l)
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=torch.float32)
    q = _round_tiles(x, u).reshape(m, x.shape[1] * block_n,
                                   x.shape[3] * block_l)
    return q[:, :N, :L].contiguous(), scales


def quant_generator(quant_seed: int, device) -> torch.Generator:
    """The rounding stream of ``quant_seed`` on ``device``.  CPU and CUDA
    generators give different draws for the same seed."""
    return torch.Generator(device=device).manual_seed(int(quant_seed))


def quantize_dequantize(H: torch.Tensor, *, block_l: int = 128,
                        block_n: int = 512, quant_seed: int = 0):
    """The int8 emulation of the oracle path: quantize H (m, N, L) per tile
    with the rounding stream of ``quant_seed`` and dequantize back to fp32.
    ``block_n`` is used as given (``ops`` resolves it first)."""
    Hq, scales = quantize_tiles(H, block_n, block_l,
                                quant_generator(quant_seed, H.device))
    N, L = H.shape[-2:]
    s = scales.repeat_interleave(block_n, dim=-2)[..., :N, :]
    return Hq.float() * s.repeat_interleave(block_l, dim=-1)[..., :L]


def int8_emulated_ref(Hdq: torch.Tensor, T: torch.Tensor):
    """The int8 stream given the dequantized H: fp32 products of the
    dequantized features against the bf16-rounded targets."""
    return gram_ref(Hdq, T.bfloat16())


def gram_tri_q_ref(Hq: torch.Tensor, scales: torch.Tensor, T: torch.Tensor,
                   block_n: int, block_l: int):
    """Plain version of the int8 kernel on given Hq (m, N, L) int8, scales
    (m, ceil(N / block_n), ceil(L / block_l)) fp32 and T (m, N, D).

    Per row block: the exact integer tile product (fp32 holds it exactly,
    see ``MAX_INT8_BLOCK_N``), times ``s_i * s_j``, added to the fp32 G in
    block order, as ``prod.astype(f32) * (s_i * s_j)`` in the reference's
    kernel; R adds the dequantized rows times the bf16 targets."""
    m, N, L = Hq.shape
    cols = torch.arange(L, device=Hq.device) // block_l
    G = torch.zeros((m, L, L), dtype=torch.float32, device=Hq.device)
    R = torch.zeros((m, L, T.shape[-1]), dtype=torch.float32,
                    device=Hq.device)
    Tf = T.bfloat16().float()
    for nb, n0 in enumerate(range(0, N, block_n)):
        q = Hq[:, n0:n0 + block_n].float()
        s = scales[:, nb][:, cols]                         # (m, L)
        G = G + (q.mT @ q) * (s[:, :, None] * s[:, None, :])
        R = R + (q * s[:, None, :]).mT @ Tf[:, n0:n0 + block_n]
    return G, R


def q_kmajor_ref(Hq: torch.Tensor, block_n: int, bnp: int) -> torch.Tensor:
    """Plain version of the int8 kernel's K-major copies.  Hq (m, N, L) ->
    (m, L, ceil(N / block_n) * bnp): row block nb's samples at positions
    [nb * bnp, nb * bnp + rows) of each row, zeros up to (nb + 1) * bnp.
    ``bnp`` holds a row block: at least min(block_n, N).  T (m, N, D)
    takes the same layout, (m, D, ...), as ``q_kmajor_ref(T, ...)``."""
    m, N, L = Hq.shape
    nn = -(-N // block_n)
    if bnp < min(block_n, N):
        raise ValueError(f"bnp {bnp} does not hold a row block of "
                         f"{min(block_n, N)} samples")
    out = torch.zeros((m, L, nn * bnp), dtype=Hq.dtype, device=Hq.device)
    for nb, n0 in enumerate(range(0, N, block_n)):
        rows = min(block_n, N - n0)
        out[:, :, nb * bnp:nb * bnp + rows] = Hq[:, n0:n0 + rows].mT
    return out
