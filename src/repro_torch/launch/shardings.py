"""Weight / optimizer / batch / cache sharding rules (the reference's
``launch/shardings.py``), and the placement of a rank's shards.

Param specs are assigned by path-pattern rules over the param tree:
  - projection "in" weights  (d, f)  -> P(fsdp, "model")
  - projection "out" weights (f, d)  -> P("model", fsdp)
  - embeddings (vocab, d)            -> P("model", fsdp)
  - MoE experts (E, d, f)            -> P("model", fsdp, None)  (expert par.)
  - 1-D scales/biases                -> replicated
Paths are the port's flat layout (``models/transformer.py``):
``layers/<l>/attn/wq/w``, ``encoder/<l>/...``, ``embed/table``.  The
reference stacks its full layer cycles on a leading axis and prepends a
``None`` to a stacked leaf's spec; the port's leaves are not stacked, so a
port leaf's spec is the reference's without that leading ``None`` (and the
cache rules have no ``cycles`` offset).

``fsdp`` is "data" for training (ZeRO-style: params, grads and optimizer
state all shard over the data axis; replicated across pods so the cross-pod
traffic is one gradient all-reduce) and None for serving (weights replicated
over data, tensor-parallel over model).

Placement: the reference places a whole array on a mesh with
``NamedSharding``.  Here each rank is a process, so the counterparts work
on one rank's part: ``local_shape`` (a rank's shard shape), ``shard`` (its
slice of a whole tensor) and ``unshard`` (the whole tensor from every
rank's part).  ``filter_specs`` drops what ``to_named`` dropped.  Every
helper reads only the mesh's axis names and sizes: a
:class:`repro_torch.core.mesh.Mesh`, or a :class:`MeshShape` for a plan of
256 ranks without a process group.
"""

from __future__ import annotations

import math
import re
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.models.sharding import BATCH_AXES, P
from repro_torch.optim.adamw import AdamWState


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without ranks or a process group."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


# (regex over "/".join(path), base_rank, spec_builder(fsdp))
_RULES = [
    (r"(embed|lm_head)/table$", 2, lambda f: P("model", f)),
    (r"attn/w[qkv]/w$", 2, lambda f: P(f, "model")),
    (r"attn/wo/w$", 2, lambda f: P("model", f)),
    (r"cross/w[qkv]/w$", 2, lambda f: P(f, "model")),
    (r"cross/wo/w$", 2, lambda f: P("model", f)),
    (r"moe/router/w$", 2, lambda f: P(f, None)),
    (r"moe/w_(gate|up)/w$", 3, lambda f: P("model", f, None)),
    (r"moe/w_down/w$", 3, lambda f: P("model", None, f)),
    (r"mlp/w_(gate|up)/w$", 2, lambda f: P(f, "model")),
    (r"mlp/w_down/w$", 2, lambda f: P("model", f)),
    (r"mlstm/w_(up|gate|q|k|v)/w$", 2, lambda f: P(f, "model")),
    (r"mlstm/w_down/w$", 2, lambda f: P("model", f)),
    (r"mlstm/w_if/(w|b)$", None, lambda f: P()),
    (r"slstm/w_x/w$", 2, lambda f: P(f, "model")),
    (r"slstm/r/w$", 3, lambda f: P(None, None, "model")),
    (r"slstm/b/b$", 2, lambda f: P()),
    (r"slstm/ffn_up/w$", 2, lambda f: P(f, "model")),
    (r"slstm/ffn_down/w$", 2, lambda f: P("model", f)),
    (r"rglru/w_(gate|rnn)/w$", 2, lambda f: P(f, "model")),
    (r"rglru/w_[ri]/w$", 2, lambda f: P(f, "model")),
    (r"rglru/w_out/w$", 2, lambda f: P("model", f)),
    (r"rglru/conv/w$", 2, lambda f: P(None, "model")),
    (r"rglru/(lam/lam|b_[ri]/b)$", 1, lambda f: P("model")),
    (r"elm_head/U$", 2, lambda f: P(f, None)),
    (r"elm_head/A$", 3, lambda f: P()),
    (r"(ln\d?|ln_cross|final_norm|enc_norm|out_norm|q_norm|k_norm)/(scale|bias)$",
     1, lambda f: P()),
]


def _path_str(path) -> str:
    return path if isinstance(path, str) else "/".join(str(p) for p in path)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, lists, tuples and named
    tuples (a named tuple's path part is the field name), keeping its
    structure; a ``P`` is a leaf."""
    if isinstance(tree, P):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def map_specs(fn, specs, tree):
    """``fn(spec, leaf)`` over the leaves of ``tree``, ``spec`` the entry
    of ``specs`` (a tree of ``P`` of the same structure) at the same place.
    Returns a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, specs[k], v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_specs(fn, s, v)
                            for s, v in zip(specs, tree, strict=True)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, s, v)
                          for s, v in zip(specs, tree, strict=True))
    return fn(specs, tree)


def spec_leaves(specs, tree) -> list:
    """The (spec, leaf) pairs of ``tree``, in its order."""
    out = []
    map_specs(lambda s, x: out.append((s, x)), specs, tree)
    return out


def spec_for_leaf(path, leaf, fsdp: Optional[str], mesh=None) -> P:
    s = _path_str(path)
    rank = len(leaf.shape)
    # MoE experts: expert-parallel over "model" when the expert count divides
    # the axis; otherwise fall back to sharding the expert-FF dimension
    # (granite's 40 experts vs model=16).
    m = re.search(r"moe/w_(gate|up|down)/w$", s)
    if m is not None:
        model_n = mesh.shape.get("model", 1) if mesh is not None else 1
        e_dim = leaf.shape[-3]
        expert_par = model_n <= 1 or (e_dim % model_n == 0)
        if m.group(1) == "down":  # (E, f, d)
            spec = P("model", None, fsdp) if expert_par else P(None, "model", fsdp)
        else:                      # (E, d, f)
            spec = P("model", fsdp, None) if expert_par else P(None, fsdp, "model")
        extra = rank - 3
        return P(*([None] * extra), *spec) if extra > 0 else spec
    for pat, base_rank, builder in _RULES:
        if re.search(pat, s):
            spec = builder(fsdp)
            if base_rank is None:
                return P()
            extra = rank - base_rank
            if extra > 0:
                spec = P(*([None] * extra), *spec)
            return spec
    # default: replicate (scalars, counters, anything unmatched)
    return P()


def param_specs(params_tree, fsdp: Optional[str] = "data", mesh=None):
    """A tree of ``P`` mirroring the params tree."""
    return _map_with_path(
        lambda path, leaf: spec_for_leaf(path, leaf, fsdp, mesh), params_tree)


def opt_specs(opt_state_shape: AdamWState, pspecs) -> AdamWState:
    """AdamW state mirrors params: (count, m, v)."""
    return AdamWState(count=P(), m=pspecs,
                      v=map_specs(lambda s, _: s, pspecs, opt_state_shape.v))


def batch_specs(batch_tree, batch_axes=BATCH_AXES):
    def leaf_spec(path, leaf):
        rest = (None,) * (len(leaf.shape) - 1)
        if leaf.shape[0] == 1:
            return P(None, *rest)  # long_500k batch=1: replicate
        return P(batch_axes, *rest)

    return _map_with_path(leaf_spec, batch_tree)


def cache_specs(cache_tree, cfg, batch_axes=BATCH_AXES):
    """Decode caches: batch over data axes; the cache SEQUENCE dim over
    "model" (always evenly divisible — KV-head counts often are not, and
    the reference's jit arguments must shard evenly); recurrent-state
    channel dims over "model".

    Leaf layouts (see repro_torch.models.cache; batch is dim 0 of every
    leaf, no layer is stacked):
      KV:          (B, S, KV, hd)      int8 lines: q (B, S, KV, hd),
                                       scale (B, S, KV, 1)
      mLSTM C:     (B, H, D, D);   n: (B, H, D);  m: (B, H)
      sLSTM c/n/h/m: (B, H, D)
      rglru h:     (B, d_rnn);     conv: (B, w-1, d_rnn)
      pos:         (B,)
    """

    def leaf_spec(path, leaf):
        s = _path_str(path)
        shape = leaf.shape
        if s.endswith("pos"):
            return P()
        spec = [None] * len(shape)
        if len(shape) > 0:
            spec[0] = batch_axes
        if re.search(r"/(k|v|ck|cv)(/(q|scale))?$", s) and len(shape) == 4:
            spec[1] = "model"                # cache sequence dim
        elif re.search(r"/C$", s) and len(shape) == 4:
            spec[-1] = "model"               # mLSTM memory column dim
        elif re.search(r"/(n|h|c|conv)$", s) and len(shape) >= 2:
            spec[-1] = "model"               # state channel dim
        return P(*spec)

    return _map_with_path(leaf_spec, cache_tree)


def _axis_size(mesh, entry) -> int:
    if isinstance(entry, (tuple, list)):
        n = 1
        for a in entry:
            n *= mesh.shape[a]
        return n
    return mesh.shape[entry]


def _filter(spec: P, mesh, shape=None) -> P:
    """Drop the axes of ``spec`` absent from the mesh and (when a shape is
    given) the axes that do not divide their dimension evenly."""
    axis_names = mesh.axis_names
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in axis_names)
            entry = kept if kept else None
        else:
            entry = entry if entry in axis_names else None
        if entry is not None and shape is not None:
            if i >= len(shape) or shape[i] % _axis_size(mesh, entry) != 0:
                entry = None
        out.append(entry)
    return P(*out)


def filter_specs(specs, mesh, tree):
    """``_filter`` of every spec against ``mesh`` and its leaf's shape in
    ``tree`` (what the reference's ``to_named`` drops)."""
    return map_specs(lambda s, x: _filter(s, mesh, x.shape), specs, tree)


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _coords(mesh, rank: int) -> dict[str, int]:
    out = {}
    for name, size in reversed(list(zip(mesh.axis_names, mesh.sizes))):
        out[name] = rank % size
        rank //= size
    return out


def _counts(ndim: int, spec: P, mesh) -> list[int]:
    """The number of blocks along each of ``ndim`` dimensions under
    ``spec`` (its axes absent from the mesh dropped)."""
    spec = _filter(spec, mesh)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than {ndim} dims")
    return [_axis_size(mesh, spec[i]) if i < len(spec) and spec[i] is not None
            else 1 for i in range(ndim)]


def _blocks(shape: Sequence[int], spec: P, mesh) -> list[int]:
    """``_counts`` of ``shape``; a dimension that its axes do not divide
    raises."""
    n = _counts(len(shape), spec, mesh)
    if any(s % k for s, k in zip(shape, n)):
        raise ValueError(f"spec {spec} does not split shape {tuple(shape)} "
                         f"evenly on the mesh {mesh.shape}")
    return n


def local_shape(shape: Sequence[int], spec: P, mesh) -> tuple[int, ...]:
    """A rank's shard shape of a ``shape`` tensor under ``spec``."""
    return tuple(s // k for s, k in zip(shape, _blocks(shape, spec, mesh)))


def _slices(shape, spec: P, mesh, coords: dict) -> tuple:
    """The index of the block of ``shape`` that the rank at ``coords`` holds:
    along a dimension split over several axes, the row-major flattening of
    its coordinates on them in the spec's order, as ``PartitionSpec``."""
    spec = _filter(spec, mesh)
    out = []
    for i, (s, k) in enumerate(zip(shape, _blocks(shape, spec, mesh))):
        idx = 0
        for a in _names(spec[i] if i < len(spec) else None):
            idx = idx * mesh.shape[a] + coords[a]
        out.append(slice(idx * (s // k), (idx + 1) * (s // k)))
    return tuple(out)


def shard(x: torch.Tensor, spec: P, mesh, coords=None) -> torch.Tensor:
    """This rank's slice of the whole tensor ``x`` under ``spec`` (a view):
    the rank of ``mesh`` (``mesh.rank``), or the one at ``coords`` (axis
    name -> coordinate, or a tuple in the mesh's order)."""
    if coords is None:
        coords = _coords(mesh, mesh.rank)
    elif not isinstance(coords, dict):
        coords = dict(zip(mesh.axis_names, coords))
    return x[_slices(x.shape, spec, mesh, coords)]


def unshard(parts: Sequence[torch.Tensor], spec: P, mesh) -> torch.Tensor:
    """The whole tensor from every rank's part under ``spec``, ``parts`` in
    rank order (ranks that replicate a block hold the same part; the last
    one's is kept)."""
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size} ranks")
    first = parts[0]
    whole = [s * k for s, k in zip(first.shape,
                                   _counts(first.ndim, spec, mesh))]
    out = first.new_empty(whole)
    for rank, part in enumerate(parts):
        out[_slices(whole, spec, mesh, _coords(mesh, rank))] = part
    return out


def plan_bytes(specs, tree, mesh, block: int = 1) -> int:
    """The bytes of a rank's shards of every leaf of ``tree`` under
    ``specs``, each leaf's rounded up to a multiple of ``block`` (512: the
    CUDA caching allocator's block)."""
    total = 0
    for spec, leaf in spec_leaves(specs, tree):
        n = math.prod(local_shape(leaf.shape, spec, mesh)) * leaf.element_size()
        total += -(-n // block) * block
    return total
