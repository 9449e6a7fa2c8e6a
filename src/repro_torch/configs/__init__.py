"""Architecture registry of the port.

Three of the reference's ten architectures are ported: the sliding-window
models whose blocks run the ``swa`` and ``rglru`` kernels, and xlstm-1.3b,
whose mLSTM blocks run the ``mlstm`` kernel.  Every other
registered name raises ``NotImplementedError`` naming the slice that brings
it (ROADMAP queue 1)."""

from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube_3_4b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
}

# the reference's other architectures, and the slice that brings each
_LATER = {
    "qwen3-moe-30b-a3b": "the LM-substrate slice (MoE blocks)",
    "granite-moe-3b-a800m": "the LM-substrate slice (MoE blocks)",
    "seamless-m4t-large-v2": "the LM-substrate slice (encoder-decoder)",
    "llava-next-34b": "the LM-substrate slice (prefix embeddings)",
    "qwen3-14b": "the LM-substrate slice (config shape data)",
    "qwen3-8b": "the LM-substrate slice (config shape data)",
    "gemma-7b": "the LM-substrate slice (config shape data)",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def _module(name: str):
    if name in _LATER:
        raise NotImplementedError(
            f"config {name!r} is not ported yet; it comes with {_LATER[name]}")
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(_ARCH_MODULES[name])


def get_config(name: str, **overrides):
    return _module(name).make_config(**overrides)


def get_smoke_config(name: str):
    return _module(name).smoke_config()
