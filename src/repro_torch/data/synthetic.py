"""Synthetic data generators for the paper's experiments.

Counterparts of the reference's ``repro/data/synthetic.py`` with the same
shapes and distributions, drawn with a ``torch.Generator`` (the numbers
differ from the reference's random streams; parity tests feed both packages
the same numpy inputs instead).  Draws happen on the CPU and move to
``device`` afterwards, so a seed gives the same data on every device.

``paper_uniform`` is the paper's §IV-A convergence setup (H, T ~ U(0,1),
stacked-H columns normalized); ``multitask_classification`` is the
digits-like generator of the §IV-B generalization study.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.elm import as_generator


def paper_uniform(gen, m=5, N=10, L=5, d=1, device="cuda"):
    """§IV-A: H_t, T_t ~ U(0,1); columns of stacked H normalized."""
    gen = as_generator(gen)
    H = torch.rand((m, N, L), generator=gen)
    Hs = H.reshape(m * N, L)
    Hs = Hs / torch.linalg.norm(Hs, dim=0, keepdim=True)
    T = torch.rand((m, N, d), generator=gen)
    return Hs.reshape(m, N, L).to(device), T.to(device)


def multitask_regression(gen, m=8, n_train=16, n_test=200, L=40, r=3, d=1,
                         noise=0.1, device="cuda"):
    """Tasks share a ground-truth subspace: T = H U* A*_t + eps.

    Returns (H_train, T_train, H_test, T_test) with task-leading axes."""
    gen = as_generator(gen)
    U_star = torch.randn((L, r), generator=gen) / math.sqrt(L)
    A_star = torch.randn((m, r, d), generator=gen)
    H_tr = torch.randn((m, n_train, L), generator=gen) / math.sqrt(L)
    H_te = torch.randn((m, n_test, L), generator=gen) / math.sqrt(L)
    T_tr = H_tr @ U_star @ A_star
    T_te = H_te @ U_star @ A_star
    T_tr = T_tr + noise * torch.randn(T_tr.shape, generator=gen) * torch.std(T_tr)
    T_te = T_te + noise * torch.randn(T_te.shape, generator=gen) * torch.std(T_te)
    return tuple(x.to(device) for x in (H_tr, T_tr, H_te, T_te))


class MultitaskClassification(NamedTuple):
    X_train: torch.Tensor   # (m, n_train, n_in)
    Y_train: torch.Tensor   # (m, n_train, n_cls) one-hot
    X_test: torch.Tensor    # (m, n_test, n_in)
    Y_test: torch.Tensor    # (m, n_test, n_cls)
    task_classes: torch.Tensor  # (m, n_cls) global class ids per task


def multitask_classification(
    gen, m: int = 10, n_train: int = 90, n_test: int = 45, n_in: int = 64,
    n_global_classes: int = 10, n_cls: int = 3, latent_r: int = 8,
    class_sep: float = 2.0, noise: float = 1.0, device="cuda",
) -> MultitaskClassification:
    """Digits-like multi-task classification (paper §IV-B shape).

    Global class prototypes live in a shared ``latent_r``-dim subspace of
    the input space; each task classifies ``n_cls`` randomly chosen global
    classes."""
    gen = as_generator(gen)
    basis = torch.randn((latent_r, n_in), generator=gen) / math.sqrt(latent_r)
    protos = class_sep * torch.randn((n_global_classes, latent_r),
                                     generator=gen) @ basis
    task_classes = torch.stack([
        torch.randperm(n_global_classes, generator=gen)[:n_cls]
        for _ in range(m)
    ])
    y_tr = torch.randint(0, n_cls, (m, n_train), generator=gen)
    y_te = torch.randint(0, n_cls, (m, n_test), generator=gen)
    rows = torch.arange(m)[:, None]
    X_tr = protos[task_classes[rows, y_tr]] + noise * torch.randn(
        (m, n_train, n_in), generator=gen)
    X_te = protos[task_classes[rows, y_te]] + noise * torch.randn(
        (m, n_test, n_in), generator=gen)
    out = (X_tr, F.one_hot(y_tr, n_cls).float(), X_te,
           F.one_hot(y_te, n_cls).float(), task_classes)
    return MultitaskClassification(*(x.to(device) for x in out))


def classification_error(pred_logits: torch.Tensor,
                         one_hot: torch.Tensor) -> torch.Tensor:
    """Mean test error (%) as in Table I."""
    pred = torch.argmax(pred_logits, dim=-1)
    true = torch.argmax(one_hot, dim=-1)
    return 100.0 * torch.mean((pred != true).float())
