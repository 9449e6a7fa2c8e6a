"""PyTorch/CUDA port of the decentralized multi-task ELM system.

Mirrors the module layout of the JAX package ``repro`` (the reference):
``repro_torch/core/engine.py`` is the counterpart of ``repro/core/engine.py``
and so on.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; functions that take tensors run where the tensors are.
"""
