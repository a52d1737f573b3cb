"""Single-token decode attention: the Hopper kernel and its plain version.

``decode_attention_cuda`` replaces
``repro/kernels/decode_attention/kernel.py::decode_attention_pallas``
(its ``pallas_call`` at line 100): one query token per sequence against
its ring KV cache, rows at or past the per-sequence ``kv_len`` unread.
The source is ``csrc/decode_attention.cu``.

What bounds it on an H100: each live cache row is read once per tick for
G = Hq/Hkv multiply-adds per element, so HBM bounds it (smollm-360m at 8
slots reads at most 8 x 512 x 5 x 64 x 2 x 2 B = 2.6 MB per layer, 0.8 us
at 3.35 TB/s).  One CTA per (sequence, kv head) serves the head's group
of q heads, so each row is read once; at 8 slots that is 40 CTAs on 132
SMs, the reason a later kernel splits the rows of one pair over several
CTAs (split-KV).

``decode_attention_plain`` computes the same function with PyTorch ops
(``ref.decode_attention_ref``).
"""
from __future__ import annotations

import ctypes

import torch

from ..common import check_launch, load_library
from .ref import decode_attention_ref

__all__ = ["decode_attention_cuda", "decode_attention_plain"]

MAX_GROUP = 8                   # q heads per kv head the kernel serves
_LAUNCHERS = {torch.float32: "decode_attention_f32",
              torch.bfloat16: "decode_attention_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_float, ctypes.c_void_p]


def decode_attention_plain(q, k, v, kv_len, *, scale: float):
    """The kernel's function in plain PyTorch ops."""
    return decode_attention_ref(q, k, v, kv_len=kv_len, scale=scale)


def _check(q, k, v, kv_len):
    if not q.is_cuda:
        raise RuntimeError(f"decode_attention_cuda needs CUDA tensors, got "
                           f"one on {q.device}")
    if q.dtype not in _LAUNCHERS:
        raise TypeError(f"decode_attention_cuda: q must be float32 or "
                        f"bfloat16, got {q.dtype}")
    B, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"decode_attention_cuda: q {tuple(q.shape)} and "
                         f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"form (B,Hq,D) x (B,Hkv,S,D)")
    if Hq % k.shape[1] or not 1 <= Hq // k.shape[1] <= MAX_GROUP:
        raise ValueError(f"decode_attention_cuda: {Hq} q heads over "
                         f"{k.shape[1]} kv heads; the group must divide "
                         f"and be <= {MAX_GROUP}")
    vec = 16 // q.element_size()
    lanes = D // vec
    if D % vec or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(f"decode_attention_cuda: head dim {D} must be "
                         f"{vec} x a power of two <= 32")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"decode_attention_cuda: {name} must be "
                            f"{q.dtype} on {q.device}")
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(t.stride(i) % vec for i in range(3))):
            raise ValueError(f"decode_attention_cuda: {name}'s rows must "
                             f"be contiguous and 16-byte aligned")
    if (kv_len.shape != (B,) or kv_len.dtype != torch.int32
            or not kv_len.is_contiguous() or kv_len.device != q.device):
        raise TypeError(f"decode_attention_cuda: kv_len must be a ({B},) "
                        f"int32 tensor on {q.device}")


def decode_attention_cuda(q, k, v, kv_len, *, scale: float):
    """Launch the CUDA kernel: q (B,Hq,D), k and v (B,Hkv,S,D) with
    contiguous, 16-byte aligned rows (any other strides), kv_len (B,)
    int32 with every entry >= 1, all on the card; float32 or bfloat16.
    Returns (B,Hq,D) in q's type.  Raises on a CPU tensor."""
    _check(q, k, v, kv_len)
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    dims = (ctypes.c_int * 5)(B, Hq, Hkv, S, D)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
        out.stride(0), out.stride(1))
    lib = load_library("decode_attention")
    fn = getattr(lib, _LAUNCHERS[q.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), dims, strides, float(scale), stream)
    check_launch(lib, "decode_attention", err)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
