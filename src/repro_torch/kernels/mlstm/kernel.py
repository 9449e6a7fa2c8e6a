"""ctypes wrapper of the CUDA chunkwise mLSTM kernel in ``csrc/mlstm.cu``;
``mlstm`` replaces ``repro/kernels/mlstm/kernel.py::mlstm_pallas``.

Given CPU tensors it returns the plain version (``ref.mlstm_chunkwise_ref``);
given CUDA tensors it launches the kernel or raises.  One call launches the
kernel's four grids (gates, states, scores, outputs) and counts one launch
in ``LAUNCHES``; nothing else counts.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import check, forward_only, on_cpu, raise_on
from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "mlstm.cu"
MAX_HEAD_DIM = 1024
LAUNCHES = {"mlstm": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    LAUNCHES["mlstm"] = 0


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built and
    loaded once per process)."""
    lib = _build.load(SOURCE)
    for name in ("mlstm_f32", "mlstm_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       ctypes.c_float, _P]
        fn.restype = _I
    lib.mlstm_workspace_floats.argtypes = [_I, _I, _I, _I, _I]
    lib.mlstm_workspace_floats.restype = ctypes.c_longlong
    return lib


def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          log_f: torch.Tensor, i_gate: torch.Tensor,
          chunk: int) -> torch.Tensor:
    """The chunkwise mLSTM from zero state.

    q, k, v: (B, H, S, D), all fp32 or all bf16; log_f (log-sigmoid forget),
    i_gate: (B, H, S) fp32; contiguous; D a multiple of 16, at most 1024.
    Chunks of ``min(chunk, S)`` steps; a ragged S is masked in the kernel.
    Returns h: (B, H, S, D) fp32, fp32 math on widened inputs."""
    forward_only("mlstm", q, k, v, log_f, i_gate)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if on_cpu("mlstm", q, k, v, log_f, i_gate):
        return mlstm_chunkwise_ref(q, k, v, log_f, i_gate, chunk)
    check("q", q, 4, (torch.float32, torch.bfloat16))
    check("k", k, 4, (q.dtype,))
    check("v", v, 4, (q.dtype,))
    check("log_f", log_f, 3, (torch.float32,))
    check("i_gate", i_gate, 3, (torch.float32,))
    B, H, S, D = q.shape
    if (k.shape != q.shape or v.shape != q.shape
            or log_f.shape != (B, H, S) or i_gate.shape != (B, H, S)):
        raise ValueError(
            f"shapes do not agree: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, log_f {tuple(log_f.shape)}, i_gate "
            f"{tuple(i_gate.shape)}")
    c = max(min(chunk, S), 1)
    if not (D % 16 == 0 and 16 <= D <= MAX_HEAD_DIM and B * H <= 65535
            and -(-S // c) <= 65535):
        raise ValueError(
            f"mlstm takes D a multiple of 16 up to {MAX_HEAD_DIM}, B * H <= "
            f"65535 and at most 65535 chunks, got {tuple(q.shape)} with "
            f"chunk {chunk}")
    out = torch.empty((B, H, S, D), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    lib = library()
    # scratch: the chunk states (4 D^2 bytes for every chunk after the
    # first), the gated scores and the gates, per (batch, head)
    work = torch.empty(4 * lib.mlstm_workspace_floats(B, H, S, D, chunk),
                       dtype=torch.uint8, device=q.device)
    fn = lib.mlstm_bf16 if q.dtype == torch.bfloat16 else lib.mlstm_f32
    stream = torch.cuda.current_stream(q.device).cuda_stream
    raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
                i_gate.data_ptr(), out.data_ptr(), work.data_ptr(), B, H, S, D,
                chunk, D ** -0.5, stream), "mlstm")
    LAUNCHES["mlstm"] += 1
    return out
