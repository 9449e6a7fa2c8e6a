"""Checkpointing: flat path->array .npz archives with tree-structure and
step metadata, in the reference's layout (``repro.checkpoint``), so either
package reads the other's checkpoints.

Layout on disk:
  <dir>/step_<n:08d>/arrays.npz   flattened leaves keyed by joined tree path
  <dir>/step_<n:08d>/meta.json    step, keys in order, per-leaf dtype
                                  strings, aux metadata

Leaves are listed in JAX's flatten order, which the reference writes: dict
keys sorted, NamedTuple and sequence entries in order, ``None`` leaves left
out.  bfloat16, which the .npz format cannot hold, is stored as a uint16
BYTE VIEW with the dtype string ``"bfloat16"`` in ``meta.json``; load
reverses the view, so every leaf round-trips bitwise (the reference stores
its ml_dtypes bfloat16 the same way).

Restore returns tensors: ``like=None`` gives the raw ``{joined/path:
tensor}`` dict (on ``device``, the CPU by default), for callers whose leaf
shapes are not known up front; a template tree ``like`` gives that tree,
each leaf on its template leaf's device.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(key, child) pairs of a container in JAX's flatten order, or None
    for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _flatten_with_names(tree, prefix: tuple = ()) -> list:
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [("/".join(prefix), tree)]
    out = []
    for key, child in kids:
        out += _flatten_with_names(child, prefix + (key,))
    return out


def _rebuild(like, values: dict, prefix: tuple = ()):
    """``like``'s structure with each leaf taken from ``values``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, values, prefix + (str(k),))
                for k, v in like.items()}
    if _is_namedtuple(like):
        return type(like)(*[_rebuild(v, values, prefix + (f,))
                            for f, v in zip(like._fields, like)])
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, values, prefix + (str(i),))
                          for i, v in enumerate(like))
    return values["/".join(prefix)]


def _to_container(leaf) -> tuple[np.ndarray, str]:
    """(the array the .npz stores, the dtype string meta.json records)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:      # numpy has no bfloat16
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.isbuiltin != 1:
        raise TypeError(f"cannot store a numpy array of dtype {arr.dtype}")
    return arr, str(arr.dtype)


def _from_container(arr: np.ndarray, dtype_str: Optional[str]) -> torch.Tensor:
    """Reverse :func:`_to_container` using the dtype string from meta.json."""
    if dtype_str is None or str(arr.dtype) == dtype_str:
        return torch.from_numpy(arr)
    if dtype_str == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    try:
        return torch.from_numpy(arr.view(np.dtype(dtype_str)))
    except TypeError:
        raise ValueError(
            f"checkpoint leaf of dtype {dtype_str!r}: not readable here"
        ) from None


def save_checkpoint(directory: str | Path, step: int, tree: Any,
                    metadata: Optional[dict] = None) -> Path:
    d = Path(directory) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    named = [(name, _to_container(leaf))
             for name, leaf in _flatten_with_names(tree)]
    np.savez(d / "arrays.npz", **{name: arr for name, (arr, _) in named})
    meta = {"step": step, "keys": [n for n, _ in named],
            "dtypes": {name: dt for name, (_, dt) in named},
            "metadata": metadata or {}}
    (d / "meta.json").write_text(json.dumps(meta, indent=2))
    return d


def latest_step(directory: str | Path) -> Optional[int]:
    d = Path(directory)
    if not d.exists():
        return None
    steps = sorted(
        int(p.name.split("_")[1]) for p in d.glob("step_*") if p.is_dir()
    )
    return steps[-1] if steps else None


def _step_dir(directory: str | Path, step: Optional[int]) -> Path:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return Path(directory) / f"step_{step:08d}"


def read_meta(directory: str | Path, step: Optional[int] = None) -> dict:
    """Read just meta.json (no array payload), e.g. to validate executor
    compatibility before committing to a full state restore."""
    return json.loads((_step_dir(directory, step) / "meta.json").read_text())


def load_checkpoint(directory: str | Path, like: Any = None,
                    step: Optional[int] = None, device=None):
    """Restore a tree saved by :func:`save_checkpoint`: ``(tree, meta)``.

    like: a tree of tensors or arrays giving the structure and each leaf's
        expected shape (each leaf comes back on its template's device, the
        CPU for a non-tensor), or ``None`` to get the raw ``{joined/path:
        tensor}`` dict of every stored leaf on ``device`` (the CPU by
        default).  Dtypes are restored from meta.json either way.
    """
    d = _step_dir(directory, step)
    meta = json.loads((d / "meta.json").read_text())
    dtypes = meta.get("dtypes", {})
    with np.load(d / "arrays.npz") as data:
        if like is None:
            raw = {name: _from_container(data[name],
                                         dtypes.get(name)).to(device or "cpu")
                   for name in meta["keys"]}
            return raw, meta
        values = {}
        for name, leaf in _flatten_with_names(like):
            arr = _from_container(data[name], dtypes.get(name))
            shape = tuple(getattr(leaf, "shape", ()))
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"checkpoint leaf {name}: shape {tuple(arr.shape)} != "
                    f"{shape}"
                )
            if isinstance(leaf, torch.Tensor):
                arr = arr.to(leaf.device)
            values[name] = arr
    return _rebuild(like, values), meta
