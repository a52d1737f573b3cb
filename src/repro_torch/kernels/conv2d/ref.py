"""Oracle for 2D convolution with fused epilogue (NHWC / HWIO).

Counterpart of ``repro/kernels/conv2d/ref.py``.  Maps stay NHWC and
weights (kh, kw, Cin, Cout) at this interface; the NCHW views PyTorch's
convolution and pools take are made inside.  On a card, cuDNN runs f32
convolutions in TF32 unless ``torch.backends.cudnn.allow_tf32`` is False:
a caller that holds a kernel against this oracle there sets it False.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..common import apply_activation

__all__ = ["conv2d_ref", "maxpool2d_ref", "avgpool2d_ref"]


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def conv2d_ref(x, w, *, stride: int = 1, pad: int = 0,
               bias=None, activation: str | None = None,
               bypass=None, bypass_first: bool = False) -> torch.Tensor:
    """x: (B, H, W, Cin); w: (kh, kw, Cin, Cout)."""
    out = _nhwc(F.conv2d(_nchw(x.float()), w.float().permute(3, 2, 0, 1),
                         stride=stride, padding=pad))
    if bias is not None:
        out = out + bias.float()
    if bypass is not None and bypass_first:
        out = out + bypass.float()
    out = apply_activation(out, activation)
    if bypass is not None and not bypass_first:
        out = out + bypass.float()
    return out.to(x.dtype)


def maxpool2d_ref(x, *, window: int, stride: int, pad: int = 0
                  ) -> torch.Tensor:
    """Max pool; padding counts as -inf (lax.reduce_window's init)."""
    return _nhwc(F.max_pool2d(_nchw(x), window, stride, pad))


def avgpool2d_ref(x, *, window: int, stride: int, pad: int = 0
                  ) -> torch.Tensor:
    """Average pool dividing by the fixed window^2, padding included."""
    s = F.avg_pool2d(_nchw(x.float()), window, stride, pad,
                     count_include_pad=True)
    return _nhwc(s).to(x.dtype)
