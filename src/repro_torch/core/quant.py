"""int8 quantization: per-channel weights and per-page KV pools
(counterpart of the int8 section of ``repro/core/quant.py``).

Every function keeps the reference's order of operations -- divide by
the scale (never multiply by a reciprocal), round half to even, clip to
+-127, cast -- so an int8 pool quantized here equals the reference's
exactly.  A zero page (or channel) gets scale 1.0, so dequantization is
always defined.  The reference's fixed-point Q-formats are not carried
yet (ROADMAP A.2).
"""
from __future__ import annotations

import torch

__all__ = ["int8_quantize_per_channel", "int8_quantize_pages",
           "int8_dequantize_pages", "int8_requantize_page"]


def _round_clip_int8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x).clamp(-127, 127).to(torch.int8)


def int8_quantize_per_channel(w: torch.Tensor, axis: int = 0
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 weight quantization: (q int8,
    scale float32 with ``axis`` kept as size 1)."""
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return _round_clip_int8(w / scale), scale.float()


def int8_quantize_pages(x: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-page int8 quantization of a page-shaped tensor.

    ``x`` is (n_pages, ...): every axis after the first belongs to one
    page (rows, kv heads, head dim for a KV pool).  One float32 scale
    per page, ``amax(page) / 127``, 1.0 for a zero page.  Returns (q
    int8 of x.shape, scales (n_pages,) float32)."""
    xf = x.float()
    amax = xf.abs().amax(dim=tuple(range(1, x.ndim)))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    sh = scale.reshape((-1,) + (1,) * (x.ndim - 1))
    return _round_clip_int8(xf / sh), scale


def int8_dequantize_pages(q: torch.Tensor, scales: torch.Tensor
                          ) -> torch.Tensor:
    """Inverse of :func:`int8_quantize_pages`: each page's scale
    broadcast back over its rows, in float32."""
    return q.float() * scales.reshape((-1,) + (1,) * (q.ndim - 1))


def int8_requantize_page(q: torch.Tensor, old_scale: torch.Tensor,
                         new_scale: torch.Tensor) -> torch.Tensor:
    """Re-express int8 pages under a larger scale: ``round(q * old /
    new)``.  Exact when the scale is unchanged, the common decode case.
    ``old_scale`` / ``new_scale`` are (n_pages,) or already broadcast
    against ``q``."""
    ratio = old_scale / new_scale
    if ratio.ndim == 1 and q.ndim > 1:
        ratio = ratio.reshape((-1,) + (1,) * (q.ndim - 1))
    return _round_clip_int8(q.float() * ratio)
