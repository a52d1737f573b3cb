"""Single-token decode attention, contiguous and paged: the Hopper kernels
and their plain versions.

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

``paged_decode_attention_cuda`` replaces ``paged_decode_attention_pallas``
(its ``pallas_call`` at line 222): the same decode with each sequence's
rows gathered page by page through a (B, pages_per_slot) int32 table from
(n_pages, page_size, Hkv, D) pools, f32 / bf16 pools as they are and int8
pools dequantized with one f32 scale per page.  The source is
``csrc/paged_decode_attention.cu``: the contiguous kernel's design with
the address taken through the table, each row group owning whole pages
so it reads a page id once per page.  HBM bounds it as it bounds the
contiguous kernel; an int8 pool halves the bytes.
``paged_decode_attention_plain`` is ``gather_pages`` +
``decode_attention_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import check_launch, load_library
from .ref import decode_attention_ref, paged_decode_attention_ref

__all__ = ["decode_attention_cuda", "decode_attention_plain",
           "paged_decode_attention_cuda", "paged_decode_attention_plain"]

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
    if D % vec or D > 32 * vec:
        raise ValueError(f"decode_attention_cuda: head dim {D} must be a "
                         f"multiple of {vec} up to {32 * vec}")
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


# The paged kernel's operand type codes (csrc/paged_decode_attention.cu).
_PAGED_Q = {torch.float32: 0, torch.bfloat16: 1}
_PAGED_KV = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_PAGED_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                   + [ctypes.c_float, ctypes.c_void_p])


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, kv_len, *,
                                 scale: float, k_scale=None, v_scale=None):
    """The paged kernel's function in plain PyTorch ops."""
    return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                      kv_len=kv_len, scale=scale,
                                      k_scale=k_scale, v_scale=v_scale)


def _check_paged(q, k_pages, v_pages, page_table, kv_len, k_scale, v_scale):
    name = "paged_decode_attention_cuda"
    if not q.is_cuda:
        raise RuntimeError(f"{name} needs CUDA tensors, got one on "
                           f"{q.device}")
    if q.dtype not in _PAGED_Q or q.stride(2) != 1:
        raise TypeError(f"{name}: q must be float32 or bfloat16 with its "
                        f"head dim contiguous, got {q.dtype}")
    B, Hq, D = q.shape
    if (k_pages.shape != v_pages.shape or k_pages.ndim != 4
            or k_pages.shape[3] != D):
        raise ValueError(f"{name}: q {tuple(q.shape)} and pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)} do "
                         f"not form (B,Hq,D) x (n_pages,page,Hkv,D)")
    n_pages, _, Hkv, _ = k_pages.shape
    if Hq % Hkv or not 1 <= Hq // Hkv <= MAX_GROUP:
        raise ValueError(f"{name}: {Hq} q heads over {Hkv} kv heads; the "
                         f"group must divide and be <= {MAX_GROUP}")
    if k_pages.dtype not in _PAGED_KV:
        raise TypeError(f"{name}: pools must be float32, bfloat16 or int8, "
                        f"got {k_pages.dtype}")
    vec = 16 // k_pages.element_size()
    lanes = D // vec
    if D % vec or lanes > 32 or lanes & (lanes - 1):
        raise ValueError(f"{name}: head dim {D} must be {vec} x a power of "
                         f"two <= 32 for {k_pages.dtype} pools")
    for label, t in (("v_pages", v_pages), ("k_pages", k_pages)):
        if (t.dtype != k_pages.dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name}: {label} must be a contiguous, "
                             f"16-byte aligned {k_pages.dtype} pool on "
                             f"{q.device}")
    quant = k_pages.dtype == torch.int8
    for label, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if quant != (t is not None):
            raise ValueError(f"{name}: {label} is required exactly for "
                             f"int8 pools")
        if t is not None and (t.shape != (n_pages,) or t.dtype
                              != torch.float32 or not t.is_contiguous()
                              or t.device != q.device):
            raise TypeError(f"{name}: {label} must be a contiguous "
                            f"({n_pages},) float32 tensor on {q.device}")
    if (page_table.ndim != 2 or page_table.shape[0] != B
            or page_table.dtype != torch.int32
            or not page_table.is_contiguous()
            or page_table.device != q.device):
        raise TypeError(f"{name}: page_table must be a contiguous ({B}, "
                        f"pages_per_slot) int32 tensor on {q.device}")
    if (kv_len.shape != (B,) or kv_len.dtype != torch.int32
            or not kv_len.is_contiguous() or kv_len.device != q.device):
        raise TypeError(f"{name}: kv_len must be a ({B},) int32 tensor on "
                        f"{q.device}")


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table, kv_len, *,
                                scale: float, k_scale=None, v_scale=None):
    """Launch the paged CUDA kernel: q (B,Hq,D) float32 or bfloat16 with D
    contiguous; k_pages and v_pages contiguous (n_pages, page_size, Hkv,
    D) pools in float32, bfloat16 or int8 (then k_scale and v_scale
    (n_pages,) float32); page_table (B, pages_per_slot) and kv_len (B,)
    int32, every kv_len >= 1 and every page the first kv_len rows touch
    mapped.  All on the card.  Returns (B,Hq,D) in q's type.  Raises on
    a CPU tensor."""
    _check_paged(q, k_pages, v_pages, page_table, kv_len, k_scale, v_scale)
    B, Hq, D = q.shape
    _, page_size, Hkv, _ = k_pages.shape
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    dims = (ctypes.c_int * 6)(B, Hq, Hkv, D, page_size, page_table.shape[1])
    strides = (ctypes.c_longlong * 4)(q.stride(0), q.stride(1),
                                      out.stride(0), out.stride(1))
    lib = load_library("paged_decode_attention")
    fn = lib.paged_decode_attention
    fn.argtypes, fn.restype = _PAGED_ARGTYPES, ctypes.c_int
    scales = [None if t is None else t.data_ptr() for t in (k_scale, v_scale)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_PAGED_Q[q.dtype], _PAGED_KV[k_pages.dtype], q.data_ptr(),
                 k_pages.data_ptr(), v_pages.data_ptr(), *scales,
                 page_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                 dims, strides, float(scale), stream)
    check_launch(lib, "paged_decode_attention", err)
    paged_decode_attention_cuda.launches += 1
    return out


paged_decode_attention_cuda.launches = 0
