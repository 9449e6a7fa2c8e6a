"""Extreme Learning Machine primitives (paper §II-A).

An ELM is a single-hidden-layer network whose hidden weights ``(W, b)`` are
drawn once and never trained; only the output weights ``beta`` are learned,
in closed form (eq. 4).  ``ELMFeatureMap`` is the map h(X); ``elm_fit`` is
Local-ELM, the paper's single-task baseline.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.core.solvers import ridge_solve
from repro_torch.kernels.gram.ref import ACTIVATIONS as _KERNEL_ACTIVATIONS

Activation = Callable[[torch.Tensor], torch.Tensor]

# The same table the fused Gram kernel's plain version applies (gelu is the
# tanh approximation, the reference's default).
ACTIVATIONS: dict[str, Activation] = _KERNEL_ACTIVATIONS


@dataclasses.dataclass(frozen=True)
class ELMFeatureMap:
    """Frozen random hidden layer h(X) = g(X W + b), W: (n, L), b: (L,)."""

    W: torch.Tensor
    b: torch.Tensor
    activation: str = "sigmoid"

    @property
    def L(self) -> int:
        return self.W.shape[1]

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        return ACTIVATIONS[self.activation](X @ self.W + self.b)


def as_generator(gen: torch.Generator | int) -> torch.Generator:
    """A CPU ``torch.Generator``: the one given, or a new one seeded with an
    int.  Draws happen on the CPU and move to the device afterwards, so the
    same seed gives the same numbers on every device."""
    if isinstance(gen, torch.Generator):
        return gen
    return torch.Generator().manual_seed(int(gen))


def make_feature_map(
    gen: torch.Generator | int, n_in: int, L: int,
    activation: str = "sigmoid", dist: str = "uniform",
    dtype=torch.float32, device="cuda",
) -> ELMFeatureMap:
    """Draw the hidden layer: ``dist="uniform"`` U(-1, 1) weights and biases,
    or ``"normal"`` N(0, 1/n_in) weights and N(0, 1) biases."""
    gen = as_generator(gen)
    if dist == "uniform":
        W = torch.rand((n_in, L), generator=gen, dtype=dtype) * 2.0 - 1.0
        b = torch.rand((L,), generator=gen, dtype=dtype) * 2.0 - 1.0
    elif dist == "normal":
        W = torch.randn((n_in, L), generator=gen, dtype=dtype) / math.sqrt(n_in)
        b = torch.randn((L,), generator=gen, dtype=dtype)
    else:
        raise ValueError(f"unknown dist {dist}")
    return ELMFeatureMap(W=W.to(device), b=b.to(device), activation=activation)


def elm_fit(H: torch.Tensor, T: torch.Tensor, mu: float) -> torch.Tensor:
    """Local-ELM closed form (eq. 4): beta* = (H^T H + mu I)^-1 H^T T;
    batched over leading task axes."""
    return ridge_solve(H, T, mu)


def elm_predict(fmap: ELMFeatureMap, beta: torch.Tensor,
                X: torch.Tensor) -> torch.Tensor:
    """Paper eq. (5)."""
    return fmap(X) @ beta


def elm_objective(H: torch.Tensor, T: torch.Tensor, beta: torch.Tensor,
                  mu: float) -> torch.Tensor:
    """Paper eq. (2)."""
    return 0.5 * torch.sum((H @ beta - T) ** 2) + 0.5 * mu * torch.sum(beta**2)
