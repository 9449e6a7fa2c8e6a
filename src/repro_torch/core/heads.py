"""MultiTaskELMHead: the paper's technique on top of a backbone of the
model zoo.

The frozen backbone plays the ELM's random hidden layer: ``pooled_features``
encodes each agent's token batch and mean-pools it over the sequence.  The
pooled features stream into the engine's sufficient statistics (on the card
through the fused Gram kernel), and the head's per-task weights
``beta_t = U_t A_t`` are fitted over those statistics.

``fit_head`` fits them with one agent per rank over a mesh
(``engine.fit_sharded``, the ring/torus of its axes); ``fit_head_local``
is the single-device Local-ELM baseline.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import engine
from repro_torch.core.engine import ConsensusConfig as DMTLELMConfig
from repro_torch.core.engine import SufficientStats
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import encode


@torch.no_grad()
def pooled_features(backbone_params, cfg: ModelConfig, tokens: torch.Tensor,
                    mask: Optional[torch.Tensor] = None, *,
                    use_kernel: bool = True,
                    **frontend_kwargs) -> torch.Tensor:
    """Frozen-backbone features, mean-pooled over valid tokens.

    tokens: (m, B, S) per-agent batches; mask: (m, B, S') valid-token mask
    or None, S' the length of ``encode``'s output (P + S with prefix
    embeddings).  ``frontend_kwargs`` (``prefix_embeds`` (B, P, d),
    ``enc_embeds`` (B, F, d)) go to ``encode`` for every agent, as the
    reference passes them.  Encodes one agent at a time (the reference
    vmaps over agents).  ``use_kernel=False`` runs the backbone's kernels'
    plain versions on any device.  Returns (m, B, d_model) fp32."""
    feats = []
    for a in range(tokens.shape[0]):
        h = encode(backbone_params, cfg, tokens[a], use_kernel=use_kernel,
                   **frontend_kwargs).float()
        if mask is None:
            feats.append(h.mean(dim=1))
            continue
        w = mask[a].float()[..., None]
        feats.append((h * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0))
    return torch.stack(feats)


@dataclasses.dataclass(frozen=True)
class MultiTaskELMHead:
    """The fitted (U_t, A_t) with prediction helpers."""

    U: torch.Tensor    # (m, L, r)
    A: torch.Tensor    # (m, r, d)

    def predict(self, H: torch.Tensor, task: int) -> torch.Tensor:
        return H @ self.U[task] @ self.A[task]

    def predict_all(self, H: torch.Tensor) -> torch.Tensor:
        """H: (m, B, L) -> (m, B, d), each agent with its own head."""
        return torch.einsum("mbl,mlr,mrd->mbd", H, self.U, self.A)


def fit_head(stats: SufficientStats, mesh, agent_axes: Sequence[str],
             cfg: DMTLELMConfig) -> tuple[MultiTaskELMHead, dict]:
    """Decentralized fit over accumulated statistics (Algorithm 2/3) with
    one agent per rank of ``mesh``: the shared ``engine.agent_update`` on
    the ring/torus of ``agent_axes`` (``engine.fit_sharded``).  Every rank
    calls it and gets every agent's head."""
    U, A, diags = engine.fit_sharded(stats, mesh, agent_axes, cfg)
    return MultiTaskELMHead(U=U, A=A), diags


def fit_head_local(stats: SufficientStats, cfg: DMTLELMConfig) -> MultiTaskELMHead:
    """Local-ELM heads, no sharing: per-agent ridge on its own statistics,
    represented as U_t = beta_t (L x d), A_t = I_d."""
    L = stats.G.shape[-1]
    eye = torch.eye(L, dtype=stats.G.dtype, device=stats.G.device)
    beta = torch.linalg.solve(stats.G + cfg.mu2 * eye, stats.R)   # (m, L, d)
    m, _, d = stats.R.shape
    A = torch.eye(d, dtype=beta.dtype, device=beta.device).expand(m, d, d)
    return MultiTaskELMHead(U=beta, A=A)
