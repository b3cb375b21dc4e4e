"""Assigned architecture registry: ``get_config(name)`` / ``ARCHS``."""

from __future__ import annotations

import importlib

ARCHS = [
    "musicgen-medium",
    "moonshot-v1-16b-a3b",
    "llama-3.2-vision-11b",
    "qwen2-7b",
    "phi4-mini-3.8b",
    "jamba-v0.1-52b",
    "qwen2-0.5b",
    "mamba2-130m",
    "granite-moe-1b-a400m",
    "olmoe-1b-7b",
]

_MODULES = {name: name.replace("-", "_").replace(".", "_") for name in ARCHS}


def get_config(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
