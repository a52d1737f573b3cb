"""Flash-attention forward: the Hopper kernel and its plain version.

``flash_attention_cuda`` replaces
``repro/kernels/flash_attention/kernel.py::flash_attention_pallas`` (its
``pallas_call`` at line 125): softmax attention with the causal, window
and ``kv_len`` masks, GQA through ``kv head = h // group``, returning the
output and the per-row logsumexp.  The source is
``csrc/flash_attention.cu``; its header says how the TPU's VMEM-sized
(block_q, block_kv) grid maps onto 64 x 64 CTA tiles.

What bounds it on an H100: the smollm-360m prefill (Sq = Skv = 512,
D = 64, 15 q heads, causal) does 0.5 GFLOP over 2.6 MB of q, k, v, out
and lse in bf16, about 190 FLOP per byte: under the card's bf16 ridge
(989 TFLOP/s over 3.35 TB/s, about 295), so HBM bounds it, with the
tensor-core bound close behind.  The first kernel is a SIMT loop far
from either bound (ROADMAP B.3).

``flash_attention_plain`` computes the same function with PyTorch ops
(``ref.flash_ref``); the CPU path and the on-card comparisons use it.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import check_launch, load_library
from .ref import flash_ref

__all__ = ["flash_attention_cuda", "flash_attention_plain"]

# Head dims the kernel takes: multiples of 8 up to 128, each on the
# tiles of the next multiple of 32 (csrc/flash_attention.cu).
HEAD_DIMS = tuple(range(8, 129, 8))
_LAUNCHERS = {torch.float32: "flash_attention_f32",
              torch.bfloat16: "flash_attention_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_float] + [ctypes.c_int] * 3
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
    if q.dtype not in _LAUNCHERS:
        raise TypeError(f"flash_attention_cuda: q must be float32 or "
                        f"bfloat16, got {q.dtype}")
    B, Hq, Sq, D = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or Hq % k.shape[1]):
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} and "
                         f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"form (B,Hq,Sq,D) x (B,Hkv,Skv,D), Hq % Hkv == 0")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head dim {D} is not a "
                         f"multiple of 8 up to 128")
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
    """Launch the CUDA kernel: q (B,Hq,Sq,D), k and v (B,Hkv,Skv,D), all
    float32 or all bfloat16 on the card, any strides with D contiguous;
    D in ``HEAD_DIMS``.  Returns (out (B,Hq,Sq,D) in q's type, lse
    (B,Hq,Sq) f32).  ``out`` is a (B,Hq,Sq,D) view of a (B,Sq,Hq,D)
    buffer, the executor's layout.  Raises on a CPU tensor."""
    _check(q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    dims = (ctypes.c_int * 6)(B, Hq, Hkv, Sq, Skv, D)
    strides = (ctypes.c_longlong * 12)(
        *[t.stride(i) for t in (q, k, v, out) for i in range(3)])
    lib = load_library("flash_attention")
    fn = getattr(lib, _LAUNCHERS[q.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), dims, strides, float(scale), int(causal),
                 int(window or 0), Skv if kv_len is None else int(kv_len),
                 stream)
    check_launch(lib, "flash_attention", err)
    flash_attention_cuda.launches += 1
    return out, lse


flash_attention_cuda.launches = 0
