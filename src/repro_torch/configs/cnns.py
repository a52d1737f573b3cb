"""The paper's own CNN workloads: AlexNetOWT, ResNet18, ResNet50.

Layer tables match the paper's Table 1 conv parameters exactly
(AlexNetOWT conv2..5: 27x27,5x5,64,192 / 13x13,3x3,192,384 /
13x13,3x3,384,256 / 13x13,3x3,256,256) and torchvision's
ResNet18/ResNet50 shapes (the paper benchmarks fb.resnet.torch
pretrained ResNet18).
"""
from __future__ import annotations

from .base import CNNConfig, CNNLayer

C = CNNLayer


def _alexnet_owt() -> CNNConfig:
    return CNNConfig(
        name="alexnet-owt", input_hw=224, input_ch=3,
        layers=(
            C("conv", 64, 11, 4, 2),            # -> 55x55x64
            C("maxpool", k=3, stride=2),        # -> 27x27
            C("conv", 192, 5, 1, 2),            # Table1 row 1
            C("maxpool", k=3, stride=2),        # -> 13x13
            C("conv", 384, 3, 1, 1),            # Table1 row 2
            C("conv", 256, 3, 1, 1),            # Table1 row 3
            C("conv", 256, 3, 1, 1),            # Table1 row 4
            C("maxpool", k=3, stride=2),        # -> 6x6
            C("fc", 4096), C("fc", 4096), C("fc", 1000, activation=None),
        ))


def _basic_block(layers, c, stride, project):
    """ResNet18 basic block: main path conv-conv, optional projection
    shortcut on a parallel path, add fused into the last conv."""
    idx0 = len(layers) - 1                      # the block's input layer
    if project:
        layers.append(C("conv", c, 1, stride, 0, activation=None,
                        input_of=idx0))
        short = len(layers) - 1
    else:
        short = idx0
    layers.append(C("conv", c, 3, stride, 1, input_of=idx0))
    layers.append(C("conv", c, 3, 1, 1, activation="relu",
                    bypass_of=short))
    return layers


def _resnet18() -> CNNConfig:
    layers = [
        C("conv", 64, 7, 2, 3),                 # -> 112
        C("maxpool", k=3, stride=2, pad=1),     # -> 56
    ]
    for c, blocks, stride in ((64, 2, 1), (128, 2, 2),
                              (256, 2, 2), (512, 2, 2)):
        for b in range(blocks):
            s = stride if b == 0 else 1
            _basic_block(layers, c, s, b == 0 and stride != 1)
    layers.append(C("avgpool", k=7, stride=7))
    layers.append(C("fc", 1000, activation=None))
    return CNNConfig(name="resnet18", input_hw=224, input_ch=3,
                     layers=tuple(layers))


def _bottleneck(layers, c, stride, project):
    idx0 = len(layers) - 1
    if project:
        layers.append(C("conv", 4 * c, 1, stride, 0, activation=None,
                        input_of=idx0))
        short = len(layers) - 1
    else:
        short = idx0
    layers.append(C("conv", c, 1, 1, 0, input_of=idx0))
    layers.append(C("conv", c, 3, stride, 1))
    layers.append(C("conv", 4 * c, 1, 1, 0, activation="relu",
                    bypass_of=short))
    return layers


def _resnet50() -> CNNConfig:
    layers = [
        C("conv", 64, 7, 2, 3),
        C("maxpool", k=3, stride=2, pad=1),
    ]
    for c, blocks, stride in ((64, 3, 1), (128, 4, 2),
                              (256, 6, 2), (512, 3, 2)):
        for b in range(blocks):
            _bottleneck(layers, c, stride if b == 0 else 1, b == 0)
    layers.append(C("avgpool", k=7, stride=7))
    layers.append(C("fc", 1000, activation=None))
    return CNNConfig(name="resnet50", input_hw=224, input_ch=3,
                     layers=tuple(layers))


ALEXNET_OWT = _alexnet_owt()
RESNET18 = _resnet18()
RESNET50 = _resnet50()
ALL_CNNS = (ALEXNET_OWT, RESNET18, RESNET50)
