"""Serving: prefill, the single-token decode step over a batched cache,
greedy and temperature generation, and the continuous-batching engine."""

from repro_torch.serving.steps import generate, make_serve_step, serve_step

__all__ = ["generate", "make_serve_step", "serve_step"]
