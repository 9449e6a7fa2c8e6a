"""AdamW with global-norm clipping, as plain functions on trees of tensors
(nested dicts, lists and tuples), the reference's ``optim/adamw.py``.

The optimizer state mirrors the parameter tree (m and v in fp32, ``count``
int32).  The update follows the reference's order of operations, each in
fp32: the clip scale ``min(1, clip_norm / max(|g|, 1e-9))`` with the
gradient norm reported before clipping, then the moments, the bias
corrections and ``p - (lr m^ / (sqrt(v^) + eps) + lr wd p)``, weight decay
on every leaf, cast back to p's dtype.  It is not ``torch.optim.AdamW``,
whose decay and schedule differ.

Unlike the reference's pure function, ``adamw_update`` writes the new
moments and parameters into the tensors it is given: a model at full width
keeps one copy of each (recurrentgemma-2b's fp32 parameters, gradients, m
and v are 46 GB).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` (and the same places of ``rest``),
    keeping the nesting; dicts keep their keys, tuples and lists their
    type (named tuples too)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in its own order (dict insertion order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class AdamWState(NamedTuple):
    count: torch.Tensor     # () int32, steps taken
    m: Any                  # fp32 tree like the parameters
    v: Any


def adamw_init(params) -> AdamWState:
    """Zero moments in fp32 on each parameter's device, count 0."""
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return AdamWState(
        count=torch.zeros((), dtype=torch.int32, device=device),
        m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's sum of squares, fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, cfg: AdamWConfig):
    """One AdamW step: (params, state, {"grad_norm", "lr"}), the parameters
    and moments updated in place (the returned trees hold the given
    tensors).  ``cfg.lr`` is a float or a callable of the new count."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state.count + 1
    lr = (cfg.lr(count) if callable(cfg.lr)
          else torch.tensor(cfg.lr, dtype=torch.float32))
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    bc1 = 1.0 - torch.pow(cfg.b1, count.float())
    bc2 = 1.0 - torch.pow(cfg.b2, count.float())
    lr_wd = lr * cfg.weight_decay

    def update(g, m, v, p):
        g = g.float() * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))            # b1 m + (1-b1) g
        t = g * (1 - cfg.b2)
        v.mul_(cfg.b2).add_(t.mul_(g))                   # b2 v + (1-b2) g g
        del g, t
        step = lr * (m / bc1)
        den = torch.sqrt(v / bc2).add_(cfg.eps)
        step.div_(den)
        del den
        pf = p.float()
        step.add_(lr_wd * pf)
        p.copy_(pf - step)

    tree_map(update, grads, state.m, state.v, params)    # leaf by place
    return params, AdamWState(count, state.m, state.v), {
        "grad_norm": gnorm, "lr": lr}
