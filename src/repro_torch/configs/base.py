"""CNN configuration (the paper's own models), after ``repro.configs.base``.

Only the CNN half is carried in this slice; ``ArchConfig`` and the LM
shape specs wait for the dense-LM slice (ROADMAP A.3).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["CNNLayer", "CNNConfig"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class CNNLayer:
    kind: str            # conv | maxpool | avgpool | fc
    c_out: int = 0
    k: int = 1
    stride: int = 1
    pad: int = 0
    activation: str | None = "relu"
    bypass_of: int | None = None   # layer index whose output is added
    bypass_first: bool = True      # ResNet order: add bypass, then ReLU
    input_of: int | None = None    # take input from this layer (default:
                                   # the previous one); enables parallel
                                   # paths like projection shortcuts


@dataclass(frozen=True)
class CNNConfig:
    name: str
    input_hw: int
    input_ch: int
    layers: tuple[CNNLayer, ...]
    n_classes: int = 1000
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        """The torch dtype of ``dtype`` (``repro``'s ``jdtype``)."""
        return _DTYPES[self.dtype]
