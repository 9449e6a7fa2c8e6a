"""Checks every kernel wrapper makes before it launches: where the tensors
lie, their rank, dtype and layout, and the launch's return code."""

from __future__ import annotations

import torch


def on_cpu(family: str, *tensors) -> bool:
    """True for tensors all on the CPU (the plain version runs), False for
    tensors all on one CUDA device (the kernel launches); raises otherwise."""
    device = tensors[0].device
    if device.type in ("cpu", "cuda") and all(t.device == device for t in tensors[1:]):
        return device.type == "cpu"
    raise ValueError(
        f"{family} kernels take tensors all on the CPU or all on one CUDA "
        f"device, got {sorted(str(t.device) for t in tensors)}"
    )


def raw_stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on ``t``'s device, as
    ``torch.cuda.current_stream(t.device).cuda_stream`` gives it, without
    building a ``Stream`` object (a few microseconds of host time a call)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def check(name: str, t: torch.Tensor, ndim: int, dtypes) -> None:
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def forward_only(family: str, *tensors) -> None:
    """The kernel has no backward (nor has the TPU kernel it replaces):
    refuse an input that asks for a gradient rather than drop it."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{family} is forward-only: an input requires grad; run it under "
            f"torch.no_grad() or detach the inputs"
        )


def raise_on(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {code}")
