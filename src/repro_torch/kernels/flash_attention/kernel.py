"""Flash-attention forward: the Hopper kernels, their plan and their plain
version.

``flash_attention_cuda`` replaces
``repro/kernels/flash_attention/kernel.py::flash_attention_pallas`` (its
``pallas_call`` at line 125): softmax attention with the causal, window
and ``kv_len`` masks, GQA through ``kv head = h // group``, returning the
output and the per-row logsumexp.  The source is
``csrc/flash_attention.cu``; the TPU's VMEM-sized (block_q, block_kv)
grid becomes 64-row q tiles, one a CTA, each walking 64-row kv tiles.

What bounds it on an H100: the smollm-360m prefill (Sq = Skv = 512,
D = 64, 15 q heads, causal) does 0.5 GFLOP over 2.6 MB of q, k, v, out
and lse in bf16, about 190 FLOP per byte: under the card's bf16 ridge
(989 TFLOP/s over 3.35 TB/s, about 295), so HBM bounds it, with the
tensor-core bound close behind; at one admission's 120 CTAs the launch
is latency-bound in practice.

``flash_plan`` picks one of two hand-written paths in plain Python:

- ``mma`` (bf16, every operand 16-byte aligned): bf16 tiles in shared
  memory through cp.async, S = Q K^T and P V on mma.sync with f32
  accumulators, P kept in registers and fed to P V split into bf16
  hi + lo, so the product sums P to about 16 bits, not 8.
- ``simt``: everything else (f32, whose checks are 1e-4 and which
  tensor cores would take as TF32; unaligned bf16 views): f32 tiles and
  FMAs.

``flash_attention_plain`` computes the same function with PyTorch ops
(``ref.flash_ref``); the CPU path and the on-card comparisons use it.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..common import check_launch, load_library
from .ref import flash_ref

__all__ = ["FlashPlan", "flash_attention_cuda", "flash_attention_plain",
           "flash_plan"]

# Head dims the kernels take: multiples of 8 up to 128, on the tiles of
# the next multiple of 16 (mma) or of 32 (simt).
HEAD_DIMS = tuple(range(8, 129, 8))
MAX_HEAD_DIM = 128
TILE_ROWS = 64        # q rows a CTA, kv rows a step
_LAUNCHERS = {("simt", torch.float32): "flash_attention_f32",
              ("simt", torch.bfloat16): "flash_attention_bf16",
              ("mma", torch.bfloat16): "flash_attention_mma_bf16"}


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """One launch: ``path`` ("mma" | "simt"), ``d_tile`` (the head dim's
    columns in the kernel's tiles, which picks the kernel instance) and
    the CTA grids, which the C launchers launch as given: ``grid`` for
    the forward or the dQ pass, ``kv_grid`` for the backward's dK/dV
    pass (None for the forward).  mma grids are (batch x heads, 64-row
    tiles), simt ones (64-row tiles, batch x heads)."""
    path: str
    d_tile: int
    grid: tuple[int, int]
    kv_grid: tuple[int, int] | None = None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def flash_plan(q_shape, kv_shape, dtype, *, aligned: bool = True,
               backward: bool = False) -> FlashPlan:
    """The path, D tile and grid for q (B,Hq,Sq,D) against k, v
    (B,Hkv,Skv,D) in ``dtype``.  ``aligned``: every operand's base
    pointer and batch, head and row strides are multiples of 16 bytes.
    The mma path loads 16-byte vectors, so it takes bf16 with ``aligned``
    at any D in ``HEAD_DIMS``; everything else runs on simt.  The forward
    takes D in ``HEAD_DIMS``, the backward any D up to 128 (simt where
    D is not a multiple of 8); another D raises."""
    B, Hq, Sq, D = q_shape
    Hkv, Skv = kv_shape[1], kv_shape[2]
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention_cuda: q must be float32 or "
                        f"bfloat16, got {dtype}")
    if backward and not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"flash_attention_bwd_cuda: head dim {D} is past "
                         f"the kernel's {MAX_HEAD_DIM}-column tiles")
    if not backward and D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} is not a "
                         f"multiple of 8 up to 128")
    nq, nkv = _cdiv(Sq, TILE_ROWS), _cdiv(Skv, TILE_ROWS)
    if dtype == torch.bfloat16 and aligned and D % 8 == 0:
        return FlashPlan("mma", 16 * _cdiv(D, 16), (B * Hq, nq),
                         (B * Hkv, nkv) if backward else None)
    return FlashPlan("simt", 32 * _cdiv(D, 32), (nq, B * Hq),
                     (nkv, B * Hkv) if backward else None)


def aligned16(*tensors) -> bool:
    """Every tensor's base pointer and its batch, head and row strides
    (in bytes) are multiples of 16."""
    return all(t.data_ptr() % 16 == 0
               and all(t.stride(i) * t.element_size() % 16 == 0
                       for i in range(3))
               for t in tensors)


_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_float] + [ctypes.c_int] * 3
             + [ctypes.c_void_p])


def flash_attention_plain(q, k, v, *, scale: float, causal: bool,
                          window: int | None, kv_len: int | None):
    """The kernel's function in plain PyTorch ops: (out, lse)."""
    return flash_ref(q, k, v, scale=scale, causal=causal, window=window,
                     kv_len=kv_len, return_lse=True)


def _check(q, k, v):
    if not q.is_cuda:
        raise RuntimeError(f"flash_attention_cuda needs CUDA tensors, got "
                           f"one on {q.device}")
    B, Hq, Sq, D = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or Hq % k.shape[1]):
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} and "
                         f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"form (B,Hq,Sq,D) x (B,Hkv,Skv,D), Hq % Hkv == 0")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"flash_attention_cuda: {name} must be "
                            f"{q.dtype} on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention_cuda: {name}'s head dim "
                             f"must be contiguous")


def flash_attention_cuda(q, k, v, *, scale: float, causal: bool,
                         window: int | None, kv_len: int | None):
    """Launch the planned CUDA path: q (B,Hq,Sq,D), k and v (B,Hkv,Skv,D),
    all float32 or all bfloat16 on the card, any strides with D
    contiguous; D in ``HEAD_DIMS``.  Returns (out (B,Hq,Sq,D) in q's
    type, lse (B,Hq,Sq) f32).  ``out`` is a (B,Hq,Sq,D) view of a
    (B,Sq,Hq,D) buffer, the executor's layout.  Raises on a CPU tensor.
    Counts one launch in ``launches`` and one in
    ``path_launches[plan.path]``."""
    _check(q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    plan = flash_plan(q.shape, k.shape, q.dtype,
                      aligned=aligned16(q, k, v, out))
    dims = (ctypes.c_int * 6)(B, Hq, Hkv, Sq, Skv, D)
    strides = (ctypes.c_longlong * 12)(
        *[t.stride(i) for t in (q, k, v, out) for i in range(3)])
    launch = (ctypes.c_int * 3)(plan.d_tile, *plan.grid)
    lib = load_library("flash_attention")
    fn = getattr(lib, _LAUNCHERS[(plan.path, q.dtype)])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), dims, strides, launch, float(scale),
                 int(causal), int(window or 0),
                 Skv if kv_len is None else int(kv_len), stream)
    check_launch(lib, "flash_attention", err)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.path_launches[plan.path] += 1
    return out, lse


flash_attention_cuda.launches = 0
flash_attention_cuda.path_launches = {"mma": 0, "simt": 0}
flash_attention_cuda.counters = ("launches", "path_launches")
