"""The paper's own experiment configurations (§IV).

The §IV-A synthetic convergence setup and the §IV-B generalization
experiments (USPS/MNIST-shaped, on the offline synthetic stand-ins), built
on the port's config types; the same values as the reference's
``repro.configs.paper``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.dmtl_elm import DMTLELMConfig
from repro_torch.core.mtl_elm import MTLELMConfig


@dataclasses.dataclass(frozen=True)
class PaperConvergenceSetup:
    """§IV-A: m=5 agents, H,T ~ U(0,1), Fig. 2(a) topology."""

    m: int = 5
    L: int = 5          # {5, 10}
    N: int = 10         # {10, 100}
    r: int = 2
    d: int = 1
    mu: float = 2.0     # mu = nu = 2
    rho: float = 1.0
    delta: float = 10.0


@dataclasses.dataclass(frozen=True)
class PaperGeneralizationSetup:
    """§IV-B shape: 10 tasks, 3 random classes each, over 10 global classes.

    Offline deviations: USPS/MNIST are replaced by the synthetic
    digits-like generator, whose isotropic class clusters are much easier
    per-sample than real digits; at the paper's 90 train samples every
    method reaches 0% and nothing can be compared.  So the scarce-data
    regime (12 samples/task), where the synthetic problem reproduces the
    paper's regime (Local-ELM ~4-6% error, MTL clearly better).  Features
    are column-normalized (the paper's §IV-A convention); the proximal
    constants are re-tuned to that feature scale while keeping the
    Theorem-1/2 ratios (tau' > tau for FO).
    """

    m: int = 10
    n_train: int = 12
    n_test: int = 45
    n_cls: int = 3
    n_global_classes: int = 10
    n_in: int = 64          # USPS after PCA; MNIST uses 87
    class_sep: float = 1.5
    noise: float = 1.5
    latent_r: int = 6
    L: int = 300            # hidden neurons for Table I
    r: int = 10             # latent basis tasks
    iters: int = 300
    mu: float = 0.3


def usps_like() -> PaperGeneralizationSetup:
    return PaperGeneralizationSetup(n_in=64)


def mnist_like() -> PaperGeneralizationSetup:
    # MNIST panel: higher input dim, slightly harder (paper: 6.58% local)
    return PaperGeneralizationSetup(n_in=87, class_sep=1.3, noise=1.7)


def mtl_cfg(setup: PaperGeneralizationSetup) -> MTLELMConfig:
    return MTLELMConfig(r=setup.r, mu1=setup.mu, mu2=setup.mu, iters=100)


def dmtl_cfg(setup: PaperGeneralizationSetup, first_order=False) -> DMTLELMConfig:
    # paper Table I uses tau = 20 + d_t (30 + d_t FO), zeta = 40 at raw
    # sigmoid-feature scale; re-tuned to the normalized-feature scale with
    # the same orderings (FO tau' > tau, zeta >= 0).  tau=1 diverges on the
    # star graph (hub degree 9: Theorem 1 needs a larger proximal weight;
    # tau_t = tau + d_t scales with degree but the base must cover
    # rho*m*(delta+1/2) effects); tau=2 converges.
    return DMTLELMConfig(
        r=setup.r, mu1=setup.mu, mu2=setup.mu, rho=1.0, delta=10.0,
        tau=3.0 if first_order else 2.0, zeta=1.0, iters=setup.iters,
        first_order=first_order,
    )
