"""Architecture registry: ``get_config(name)`` / ``get_smoke(name)``.

Each module defines CONFIG (the full-size config) and SMOKE (a reduced
same-family config for CPU tests), as in the JAX package, and the registry
lists the JAX package's 11 architectures. Every config prices a worker in
the serve CLI's sim mode, and ``models.api.build`` builds every one; the
executors serve all but the encdec family (whisper), which they refuse as
the JAX executor cannot serve it.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "gemma2_2b",
    "qwen2_1_5b",
    "deepseek_7b",
    "stablelm_1_6b",
    "arctic_480b",
    "kimi_k2_1t",
    "rwkv6_7b",
    "paligemma_3b",
    "zamba2_2_7b",
    "whisper_medium",
    "internlm20b",
]

_ALIASES = {
    "gemma2-2b": "gemma2_2b",
    "qwen2-1.5b": "qwen2_1_5b",
    "deepseek-7b": "deepseek_7b",
    "stablelm-1.6b": "stablelm_1_6b",
    "arctic-480b": "arctic_480b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "kimi-k2-1t": "kimi_k2_1t",
    "rwkv6-7b": "rwkv6_7b",
    "paligemma-3b": "paligemma_3b",
    "zamba2-2.7b": "zamba2_2_7b",
    "whisper-medium": "whisper_medium",
    "internlm-20b": "internlm20b",
}


def _module(name: str):
    key = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if key not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}; the registry "
                         f"has {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE


def list_archs():
    return list(ARCHS)
