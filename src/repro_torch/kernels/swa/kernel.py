"""ctypes wrapper of the CUDA sliding-window attention kernel in
``csrc/swa.cu``; ``swa`` replaces
``repro/kernels/swa/kernel.py::swa_pallas``.

Given CPU tensors it returns the plain version (``ref.swa_ref``); given
CUDA tensors it launches the kernel or raises: fp32 inputs the fp32 kernel
(CUDA cores), bf16 inputs the bf16 one (tensor cores, p split into two bf16
terms; 16-byte copies where D % 8 == 0 and q, k, v start on 16 bytes).  ``LAUNCHES`` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import check, forward_only, on_cpu, raise_on
from repro_torch.kernels.swa.ref import swa_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "swa.cu"
MAX_HEAD_DIM = 256
BLOCK_ROWS = 64      # both kernels' query tile (BQ, TQ in csrc/swa.cu)
LAUNCHES = {"swa": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    LAUNCHES["swa"] = 0


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built and
    loaded once per process)."""
    lib = _build.load(SOURCE)
    for name in ("swa_f32", "swa_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
                       _P]
        fn.restype = _I
    lib.swa_smem_bytes.argtypes = [_I, _I]
    lib.swa_smem_bytes.restype = _I
    return lib


def smem_bytes(D: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory one block of the ``dtype`` kernel takes at head
    dim D."""
    return library().swa_smem_bytes(D, int(dtype == torch.bfloat16))


def swa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        window: int) -> torch.Tensor:
    """Causal sliding-window attention in one launch.

    q: (B, H, S, D); k, v: (B, KV, S, D), all fp32 or all bf16, contiguous,
    H a multiple of KV, D <= 256.  Query i attends key j iff ``j <= i`` and
    ``i - j < window``.  Returns (B, H, S, D) in q's dtype.  fp32: fp32
    math; bf16: exact bf16 products summed in fp32, p kept to ~16 bits."""
    forward_only("swa", q, k, v)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if on_cpu("swa", q, k, v):
        return swa_ref(q, k, v, window)
    check("q", q, 4, (torch.float32, torch.bfloat16))
    check("k", k, 4, (q.dtype,))
    check("v", v, 4, (q.dtype,))
    B, H, S, D = q.shape
    KV = k.shape[1]
    if (k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, D)
            or H % KV != 0):
        raise ValueError(
            f"shapes do not agree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} (H must be a multiple of KV)")
    if not (1 <= D <= MAX_HEAD_DIM and B <= 65535 and H <= 65535
            and S < 2**31 - BLOCK_ROWS):
        raise ValueError(
            f"swa takes 1 <= D <= {MAX_HEAD_DIM}, B, H <= 65535 and S below "
            f"2^31 - {BLOCK_ROWS}, got "
            f"{tuple(q.shape)}")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = library()
    fn = lib.swa_bf16 if q.dtype == torch.bfloat16 else lib.swa_f32
    stream = torch.cuda.current_stream(q.device).cuda_stream
    raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                B, H, KV, S, D, min(window, 2**31 - 1), D ** -0.5, stream),
             "swa")
    LAUNCHES["swa"] += 1
    return o
