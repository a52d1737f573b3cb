"""Fixed-point simulation and int8 quantization (paper §5.3;
counterpart of ``repro/core/quant.py``).

The paper checks the hardware's results layer by layer against a Q8.8
software oracle and reports Q8.8 / Q5.11 accuracy.  Q(m).(f) is a
16-bit signed fixed-point format with ``f`` fractional bits.  The oracle
keeps the reference's order of operations -- scale, round half to even,
saturate, int16; an int16 x int16 product summed in int32, then one
arithmetic right shift -- so its integers equal the reference's.

The int8 half (per-channel weights, per-page KV pools) likewise keeps
the reference's order -- divide by the scale (never multiply by a
reciprocal), round half to even, clip to +-127, cast -- so an int8 pool
quantized here equals the reference's exactly.  A zero page (or
channel) gets scale 1.0, so dequantization is always defined.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["QFormat", "Q8_8", "Q5_11", "quantize", "dequantize", "qmatmul",
           "validate_layerwise", "int8_quantize_per_channel",
           "int8_quantize_pages", "int8_dequantize_pages",
           "int8_requantize_page"]


@dataclass(frozen=True)
class QFormat:
    """Signed fixed point with ``int_bits`` integer and ``frac_bits``
    fractional bits (1 sign + int + frac = 16 for the paper)."""

    int_bits: int
    frac_bits: int

    @property
    def total_bits(self) -> int:
        return 1 + self.int_bits + self.frac_bits

    @property
    def scale(self) -> float:
        return float(1 << self.frac_bits)

    @property
    def qmin(self) -> int:
        return -(1 << (self.total_bits - 1))

    @property
    def qmax(self) -> int:
        return (1 << (self.total_bits - 1)) - 1


Q8_8 = QFormat(int_bits=7, frac_bits=8)     # the paper's "Q8.8"
Q5_11 = QFormat(int_bits=4, frac_bits=11)   # the paper's "Q5.11"


def quantize(x: torch.Tensor, fmt: QFormat = Q8_8) -> torch.Tensor:
    """float -> int16 fixed point: round half to even, then saturate."""
    q = torch.round(x * fmt.scale).clamp(fmt.qmin, fmt.qmax)
    return q.to(torch.int16 if fmt.total_bits <= 16 else torch.int32)


def dequantize(q: torch.Tensor, fmt: QFormat = Q8_8) -> torch.Tensor:
    return q.float() / fmt.scale


# A float64 product of int16 values is exact while every partial sum
# stays below 2^53; each product is below 2^30 in magnitude.
_F64_EXACT_K = 1 << 23


def _int32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 ``a @ b`` summed in int32 (wrapping as the reference's int32
    dot does).  PyTorch has no integer matmul on CUDA, so a CUDA tensor
    takes a float64 matmul of the same integers, exact for K below
    ``_F64_EXACT_K``; past that it raises rather than round or move to
    the CPU."""
    if not a.is_cuda:
        return torch.matmul(a.long(), b.long()).to(torch.int32)
    K = a.shape[-1]
    if K >= _F64_EXACT_K:
        raise ValueError(f"qmatmul: K = {K} products of int16 may pass "
                         f"2^53 and round in the float64 matmul the card "
                         f"runs; K must stay below {_F64_EXACT_K}")
    return torch.matmul(a.double(), b.double()).long().to(torch.int32)


def qmatmul(a_q: torch.Tensor, b_q: torch.Tensor, fmt: QFormat = Q8_8,
            bias_q: torch.Tensor | None = None,
            relu: bool = False) -> torch.Tensor:
    """Fixed-point matmul as Snowflake's MACs run it: int16 x int16
    summed in int32, the bias added at the product's scale, one
    arithmetic right shift by ``frac_bits`` (floor), optional ReLU,
    saturation back to int16."""
    acc = _int32_matmul(a_q.to(torch.int32), b_q.to(torch.int32))
    if bias_q is not None:
        acc = acc + (bias_q.to(torch.int32) << fmt.frac_bits)
    out = acc >> fmt.frac_bits
    if relu:
        out = out.clamp_min(0)
    return out.clamp(fmt.qmin, fmt.qmax).to(torch.int16)


def validate_layerwise(float_outs: list, quant_outs: list,
                       fmt: QFormat = Q8_8) -> list[dict]:
    """Layer-by-layer result checking (paper §5.3): the float reference
    against the dequantized fixed-point path, max-abs and RMS error per
    layer in units of one LSB."""
    report = []
    lsb = 1.0 / fmt.scale
    for i, (f, q) in enumerate(zip(float_outs, quant_outs)):
        deq = (dequantize(q, fmt) if not q.dtype.is_floating_point
               else q)
        err = (f.float() - deq).abs()
        report.append({
            "layer": i,
            "max_abs_err_lsb": float(err.max() / lsb),
            "rms_err_lsb": float(torch.sqrt(torch.mean(err ** 2)) / lsb),
        })
    return report


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
