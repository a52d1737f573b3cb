"""Config registry: --arch <id> -> ArchConfig (LMs) / CNNConfig."""
from .archs import (ALL_ARCHS, DEEPSEEK_7B, GRANITE_MOE_1B, LLAMA3_8B,
                    LLAMA32_VISION_11B, LLAMA4_MAVERICK, MAMBA2, OLMO_1B,
                    RWKV6_7B, SMOLLM_360M, WHISPER_BASE, ZAMBA2_7B)
from .base import ArchConfig, CNNConfig, CNNLayer, LM_SHAPES, ShapeSpec
from .cnns import ALEXNET_OWT, ALL_CNNS, RESNET18, RESNET50

REGISTRY = {c.name: c for c in ALL_ARCHS}
CNN_REGISTRY = {c.name: c for c in ALL_CNNS}


def get_config(name: str):
    """The config named ``name`` (an ``-smoke`` suffix gives its reduced
    form)."""
    base = name.removesuffix("-smoke")
    if name in CNN_REGISTRY:
        return CNN_REGISTRY[name]
    if name in REGISTRY:
        return REGISTRY[name]
    if base in REGISTRY:
        return REGISTRY[base].smoke()
    raise KeyError(f"unknown arch {name!r}; known: "
                   f"{sorted(REGISTRY) + sorted(CNN_REGISTRY)}")


__all__ = ["ArchConfig", "CNNConfig", "CNNLayer", "LM_SHAPES", "ShapeSpec",
           "REGISTRY",
           "CNN_REGISTRY", "get_config", "ALL_ARCHS", "ALL_CNNS",
           "ALEXNET_OWT", "RESNET18", "RESNET50", "DEEPSEEK_7B", "LLAMA3_8B",
           "OLMO_1B", "SMOLLM_360M", "ZAMBA2_7B", "MAMBA2", "RWKV6_7B",
           "WHISPER_BASE", "GRANITE_MOE_1B", "LLAMA4_MAVERICK",
           "LLAMA32_VISION_11B"]
