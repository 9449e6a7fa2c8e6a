"""Architecture registry of the port: the reference's ten architectures,
under the same names and in the same order, each module a copy of the
reference's shape data (``make_config``) and smoke config."""

from __future__ import annotations

import importlib

_ARCH_MODULES = {
    "h2o-danube-3-4b": "repro_torch.configs.h2o_danube_3_4b",
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "granite-moe-3b-a800m": "repro_torch.configs.granite_moe_3b_a800m",
    "gemma-7b": "repro_torch.configs.gemma_7b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    return importlib.import_module(_ARCH_MODULES[name])


def get_config(name: str, **overrides):
    return _module(name).make_config(**overrides)


def get_smoke_config(name: str):
    return _module(name).smoke_config()
