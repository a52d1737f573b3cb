"""Config registry: --arch <id> -> CNNConfig (CNN archs only so far)."""
from .base import CNNConfig, CNNLayer
from .cnns import ALEXNET_OWT, ALL_CNNS, RESNET18, RESNET50

CNN_REGISTRY = {c.name: c for c in ALL_CNNS}

__all__ = ["CNNConfig", "CNNLayer", "CNN_REGISTRY", "ALL_CNNS",
           "ALEXNET_OWT", "RESNET18", "RESNET50"]
