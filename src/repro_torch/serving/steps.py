"""Serving steps: the single-token decode step over a batched KV/recurrent
cache, and the generation loop of the examples."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import decode_step, prefill


def serve_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache):
    """One decode step: tokens (B, 1) -> (logits (B, 1, vocab), the new
    cache)."""
    return decode_step(params, cfg, tokens, cache)


def make_serve_step(cfg: ModelConfig):
    def step(params, tokens, cache):
        return decode_step(params, cfg, tokens, cache)

    return step


def _next_token(logits: torch.Tensor, temperature: float,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, vocab) logits -> (B, 1) tokens: greedy, or drawn at
    ``temperature`` from ``generator``."""
    if temperature > 0 and generator is not None:
        probs = torch.softmax(logits.float() / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
    return logits.argmax(dim=-1, keepdim=True)


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompt: torch.Tensor, max_new: int,
             max_len: int, temperature: float = 0.0,
             generator: Optional[torch.Generator] = None, *,
             use_kernel: bool = True, **frontend_kwargs):
    """Prefill ``prompt`` (B, S), then ``max_new - 1`` decode steps.
    Returns (tokens (B, max_new) int64, the last cache).

    The first token is the prefill's argmax, as in the reference.  The
    later ones are greedy too, unless ``temperature > 0`` and a
    ``generator`` (on the logits' device) is given: then each is drawn from
    softmax(logits / T) with ``torch.multinomial`` (the reference draws
    with ``jax.random``, which is not replayed).  ``use_kernel=False`` runs
    the kernels' plain versions on any device.  ``frontend_kwargs`` go to
    ``prefill`` (``cache_dtype``, for instance)."""
    logits, cache = prefill(params, cfg, prompt, max_len,
                            use_kernel=use_kernel, **frontend_kwargs)
    out = [logits[:, -1].argmax(dim=-1, keepdim=True)]
    for _ in range(max_new - 1):
        logits, cache = decode_step(params, cfg, out[-1], cache,
                                    use_kernel=use_kernel)
        out.append(_next_token(logits[:, -1], temperature, generator))
    return torch.cat(out, dim=1), cache
