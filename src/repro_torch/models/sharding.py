"""Activation-sharding helpers and the active mesh.

The reference annotates activations with *physical* mesh axes through
``maybe_shard`` (``jax.lax.with_sharding_constraint`` under an active mesh,
a no-op without one), so the same model code runs on one CPU and on a pod.
Those constraints choose a layout and never change a value.  In the port
each rank is a process that holds whole tensors, so every helper here
returns ``x`` unchanged, with or without a mesh; what is kept is the CHOICE
of layout, which ``spec_for_*`` returns for a caller that places tensors
itself (the parameter rules of ``launch/shardings.py``) and for the tests,
which hold it against the reference's rules.

The active mesh is the counterpart of ``jax.set_mesh`` /
``get_abstract_mesh``: ``with use_mesh(mesh):`` makes a
:class:`repro_torch.core.mesh.Mesh` current in this thread and context, and
``moe.moe_ffn`` takes the expert-parallel schedule under it.

Conventions (the reference's):
  batch                  -> ("pod", "data")  (both data-parallel axes)
  heads/ff/experts/vocab -> "model"          (tensor / expert parallel)
"""

from __future__ import annotations

import contextlib
import contextvars
import os

import torch

BATCH_AXES = ("pod", "data")
MODEL_AXIS = "model"

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                         default=None)


class P(tuple):
    """A partition spec, the stand-in for ``jax.sharding.PartitionSpec``:
    one entry per tensor dimension, each None (replicated), a mesh axis
    name, or a tuple of names (a one-name tuple is that name, as
    ``PartitionSpec`` keeps it)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the active mesh inside the block (``jax.set_mesh``)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def _active_mesh():
    """The active :class:`~repro_torch.core.mesh.Mesh`, or None."""
    mesh = _ACTIVE.get()
    if mesh is None or mesh.size == 0:
        return None
    return mesh


def _filter_spec(spec, axis_names) -> P:
    """Drop the axes of ``spec`` that the mesh does not have, so that the
    same annotation serves (data, model) and (pod, data, model)."""
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
        elif isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in axis_names)
            out.append(kept if kept else None)
        else:
            out.append(entry if entry in axis_names else None)
    return P(*out)


def active_spec(spec) -> P | None:
    """``spec`` filtered to the active mesh's axes, or None without one."""
    mesh = _active_mesh()
    if mesh is None:
        return None
    return _filter_spec(spec, mesh.axis_names)


def maybe_shard(x: torch.Tensor, spec) -> torch.Tensor:
    """The reference's layout constraint: ``x`` itself (a rank holds whole
    tensors); ``active_spec(spec)`` is the layout it names."""
    return x


def _seq_shard_enabled() -> bool:
    return os.environ.get("REPRO_NO_SEQ_SHARD", "0") != "1"


def _batch_seq_spec(x: torch.Tensor) -> P:
    """(B, S, ...) activations: batch over the data axes and, for S >= 1024,
    S over "model" (sequence parallelism; ``REPRO_NO_SEQ_SHARD=1`` turns it
    off)."""
    rest = (None,) * (x.ndim - 2)
    if x.ndim >= 2 and x.shape[1] >= 1024 and _seq_shard_enabled():
        return P(BATCH_AXES, MODEL_AXIS, *rest)
    return P(BATCH_AXES, None, *rest)


def spec_for_batch_seq(x: torch.Tensor) -> P | None:
    return active_spec(_batch_seq_spec(x))


def spec_for_heads(x: torch.Tensor) -> P | None:
    """(B, S, H, D) attention tensors: batch over data, heads over model."""
    return active_spec(P(BATCH_AXES, None, MODEL_AXIS, None))


def spec_for_ff(x: torch.Tensor) -> P | None:
    """(B, S, F) MLP hidden: batch over data, features over model."""
    return active_spec(P(BATCH_AXES, None, MODEL_AXIS))


def shard_batch_seq(x: torch.Tensor) -> torch.Tensor:
    return maybe_shard(x, _batch_seq_spec(x))


def shard_heads(x: torch.Tensor) -> torch.Tensor:
    return maybe_shard(x, P(BATCH_AXES, None, MODEL_AXIS, None))


def shard_ff(x: torch.Tensor) -> torch.Tensor:
    return maybe_shard(x, P(BATCH_AXES, None, MODEL_AXIS))
