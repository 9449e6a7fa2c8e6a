"""ctypes wrapper of the CUDA RG-LRU scan kernel in ``csrc/rglru.cu``;
``rglru`` replaces ``repro/kernels/rglru/kernel.py::rglru_pallas``.

Given CPU tensors it returns the plain version (``ref.rglru_scan_ref``);
given CUDA tensors it launches the kernel or raises.  ``LAUNCHES`` counts
kernel launches, and only those.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import check, forward_only, on_cpu, raise_on
from repro_torch.kernels.rglru.ref import rglru_scan_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "rglru.cu"
LAUNCHES = {"rglru": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    LAUNCHES["rglru"] = 0


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C signature declared (built and
    loaded once per process)."""
    lib = _build.load(SOURCE)
    lib.rglru_f32.argtypes = [_P, _P, _P, _P, _I, _I, _I, _P]
    lib.rglru_f32.restype = _I
    return lib


def rglru(log_a: torch.Tensor, b: torch.Tensor,
          h0: torch.Tensor) -> torch.Tensor:
    """h_t = exp(log_a_t) * h_{t-1} + b_t in one launch.

    log_a, b: (B, S, D) fp32; h0: (B, D) fp32; contiguous.  Returns
    (B, S, D) fp32."""
    forward_only("rglru", log_a, b, h0)
    if on_cpu("rglru", log_a, b, h0):
        return rglru_scan_ref(log_a, b, h0)
    f32 = (torch.float32,)
    check("log_a", log_a, 3, f32)
    check("b", b, 3, f32)
    check("h0", h0, 2, f32)
    B, S, D = log_a.shape
    if b.shape != log_a.shape or h0.shape != (B, D):
        raise ValueError(
            f"shapes do not agree: log_a {tuple(log_a.shape)}, b "
            f"{tuple(b.shape)}, h0 {tuple(h0.shape)}")
    if not (B <= 65535 and S < 2**31 and D < 2**31):
        raise ValueError(f"rglru takes B <= 65535, got {tuple(log_a.shape)}")
    out = torch.empty_like(log_a)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(log_a.device).cuda_stream
    raise_on(library().rglru_f32(log_a.data_ptr(), b.data_ptr(),
                                 h0.data_ptr(), out.data_ptr(), B, S, D,
                                 stream), "rglru")
    LAUNCHES["rglru"] += 1
    return out
