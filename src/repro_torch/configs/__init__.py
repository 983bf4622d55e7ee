"""Architecture registry: ``get_config(name)`` / ``get_smoke(name)``.

Each module defines CONFIG (the full-size config) and SMOKE (a reduced
same-family config for CPU tests), as in the JAX package. The port carries
the dense configs without a sliding window; the other architectures come
with their slices (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import importlib

ARCHS = [
    "qwen2_1_5b",
    "deepseek_7b",
    "stablelm_1_6b",
    "internlm20b",
]

_ALIASES = {
    "qwen2-1.5b": "qwen2_1_5b",
    "deepseek-7b": "deepseek_7b",
    "stablelm-1.6b": "stablelm_1_6b",
    "internlm-20b": "internlm20b",
}


def _module(name: str):
    key = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if key not in ARCHS:
        raise NotImplementedError(
            f"architecture {name!r} is not ported to PyTorch yet; the port "
            f"has {ARCHS} (see ROADMAP.md for the order of the rest)")
    return importlib.import_module(f"repro_torch.configs.{key}")


def get_config(name: str):
    return _module(name).CONFIG


def get_smoke(name: str):
    return _module(name).SMOKE
