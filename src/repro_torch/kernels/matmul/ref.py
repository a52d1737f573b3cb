"""Plain PyTorch oracle for the scheduled matmul kernel
(counterpart of ``repro/kernels/matmul/ref.py``)."""
from __future__ import annotations

import torch

from ..common import apply_activation

__all__ = ["matmul_ref"]


def matmul_ref(a: torch.Tensor, b: torch.Tensor, *,
               bias: torch.Tensor | None = None,
               activation: str | None = None,
               bypass: torch.Tensor | None = None) -> torch.Tensor:
    """C = epilogue(A @ B):  f32 accumulation, optional bias add,
    activation and residual-bypass add (the paper's fused writeback)."""
    acc = torch.matmul(a.float(), b.float())
    if bias is not None:
        acc = acc + bias.float()
    acc = apply_activation(acc, activation)
    if bypass is not None:
        acc = acc + bypass.float()
    return acc.to(a.dtype)
