"""Assigned architecture configs (--arch <id>)."""

import importlib

from .base import ArchConfig, ShapeConfig, SHAPES, reduced

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "reduced", "ARCH_IDS",
           "get_config", "cells"]

_MODULES = {
    "h2o-danube-3-4b": "h2o_danube3_4b",
    "starcoder2-15b": "starcoder2_15b",
    "yi-6b": "yi_6b",
    "gemma3-4b": "gemma3_4b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "rwkv6-7b": "rwkv6_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "whisper-tiny": "whisper_tiny",
    "internvl2-1b": "internvl2_1b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; available: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG


def cells(arch_id: str):
    """The (arch x shape) cells this arch runs (long_500k gated)."""
    cfg = get_config(arch_id)
    for shape_name, shape in SHAPES.items():
        if shape_name == "long_500k" and not cfg.supports_long_context:
            continue
        yield shape_name, shape
