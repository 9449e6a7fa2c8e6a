"""ctypes wrapper of the CUDA chunkwise mLSTM kernel in ``csrc/mlstm.cu``;
``mlstm`` replaces ``repro/kernels/mlstm/kernel.py::mlstm_pallas``.

Given CPU tensors it returns the plain version (``ref.mlstm_chunkwise_ref``);
given CUDA tensors it launches the kernel or raises.  One call launches the
kernel's four grids (gates, states, scores, outputs) and counts one launch
in ``LAUNCHES``; nothing else counts.  The grids have one body per dtype:
fp32 the FMA body on the CUDA cores, bf16 the tensor-core body (the state
update and C q on mma.sync, their fp32 operand split into bf16 terms; the
scores and S V as in fp32); ``LAST_MLSTM`` records what the last call on the
card ran, as the library reports it.
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
# what the last call on the card ran: its dtype, its body ("mma" or "fma")
# and the bf16 terms of each split operand (w v and the stored states C; none
# in fp32)
LAST_MLSTM = {"dtype": None, "body": None, "terms": None}

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
    lib.mlstm_workspace_floats.argtypes = [_I, _I, _I, _I, _I, _I]
    lib.mlstm_workspace_floats.restype = ctypes.c_longlong
    lib.mlstm_body.argtypes = [_I, ctypes.POINTER(_I)]
    lib.mlstm_body.restype = _I
    return lib


def body(bf16: bool) -> dict:
    """The body the library runs for bf16 (or fp32) inputs, as it reports
    it: ``{"body": "mma" or "fma", "terms": {"wv": n, "C": n}}``."""
    terms = (_I * 2)()
    tc = library().mlstm_body(int(bf16), terms)
    return {"body": "mma" if tc else "fma",
            "terms": dict(zip(("wv", "C"), terms))}


def _on_16_bytes(x: torch.Tensor) -> torch.Tensor:
    """``x``, or a copy of it in a fresh allocation where it does not start
    on 16 bytes (the bf16 body stages rows by 16-byte copies)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def mlstm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          log_f: torch.Tensor, i_gate: torch.Tensor,
          chunk: int) -> torch.Tensor:
    """The chunkwise mLSTM from zero state.

    q, k, v: (B, H, S, D), all fp32 or all bf16; log_f (log-sigmoid forget),
    i_gate: (B, H, S) fp32; contiguous; D a multiple of 16, at most 1024.
    Chunks of ``min(chunk, S)`` steps; a ragged S is masked in the kernel.
    Returns h: (B, H, S, D) fp32: fp32 math on widened inputs (fp32), or,
    for bf16, the two D x D products as bf16 products into fp32 sums with
    their fp32 operand split into bf16 terms."""
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
    bf16 = q.dtype == torch.bfloat16
    if bf16:
        q, k, v = (_on_16_bytes(x) for x in (q, k, v))
    # scratch: the chunk states (4 D^2 bytes for every chunk after the
    # first), the gated scores and the gates, per (batch, head)
    work = torch.empty(4 * lib.mlstm_workspace_floats(B, H, S, D, chunk, bf16),
                       dtype=torch.uint8, device=q.device)
    fn = lib.mlstm_bf16 if bf16 else lib.mlstm_f32
    stream = torch.cuda.current_stream(q.device).cuda_stream
    raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), log_f.data_ptr(),
                i_gate.data_ptr(), out.data_ptr(), work.data_ptr(), B, H, S, D,
                chunk, D ** -0.5, stream), "mlstm")
    LAUNCHES["mlstm"] += 1
    LAST_MLSTM.update(dtype="bf16" if bf16 else "fp32", **body(bf16))
    return out
