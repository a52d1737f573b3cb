"""Single-token decode attention, contiguous and paged: the Hopper kernels
and their plain versions.

``decode_attention_cuda`` replaces
``repro/kernels/decode_attention/kernel.py::decode_attention_pallas``
(its ``pallas_call`` at line 100): one query token per sequence against
its ring KV cache, rows at or past the per-sequence ``kv_len`` unread.
The cache is in q's type or in float8 e4m3 (``kv_dtype="float8"``),
read in its own bytes and widened to f32 inside the kernel, as the
reference casts each K/V tile to f32 inside its kernel.  The source is
``csrc/decode_attention.cu``.

``paged_decode_attention_cuda`` replaces ``paged_decode_attention_pallas``
(its ``pallas_call`` at line 222): the same decode with each sequence's
rows gathered page by page through a (B, pages_per_slot) int32 table from
(n_pages, page_size, Hkv, D) pools, f32 / bf16 pools as they are and int8
pools dequantized with one f32 scale per page.  The source is
``csrc/paged_decode_attention.cu``.

What bounds them on an H100: each live cache row is read once per tick
for G = Hq/Hkv multiply-adds per element, so HBM bounds them (smollm-360m
at 8 slots reads at most 8 x 512 x 5 x 64 x 2 x 2 B = 2.6 MB per layer,
0.8 us at 3.35 TB/s); an int8 pool halves the bytes.  At a few MB a
tick, latency and an idle card cost more than bytes.  Both kernels are
one split-KV design (``csrc/decode_split.cuh``): ``decode_plan`` splits
each (sequence, kv head) pair's cache rows into ``splits`` spans of
``split_rows`` rows, so the grid (B * Hkv, splits) fills the card; each
CTA stages row tiles of K and V in shared memory with cp.async, takes
the softmax once per tile and keeps an f32 partial, and the splits of a
pair, one thread-block cluster, merge the partials in split order
through distributed shared memory: one launch, no workspace.  The plan
reads shapes only, never ``kv_len`` or the page table, so a call does no
host sync and can be captured in a CUDA graph; the output is the same
bits from run to run.

``decode_attention_plain`` computes the same function with PyTorch ops
(``ref.decode_attention_ref``); ``paged_decode_attention_plain`` is
``gather_pages`` + ``decode_attention_ref``.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..common import check_launch, load_library
from .ref import decode_attention_ref, paged_decode_attention_ref

__all__ = ["DecodePlan", "decode_plan", "decode_attention_cuda",
           "decode_attention_plain", "paged_decode_attention_cuda",
           "paged_decode_attention_plain"]

MAX_GROUP = 8                   # q heads per kv head the kernel serves
TARGET_CTAS = 4 * 132           # four CTAs per SM of an H100
MAX_SPLITS = 8                  # CTAs of one cluster (csrc/decode_split.cuh)
_CONTIGUOUS = "decode_attention_cuda"
_PAGED = "paged_decode_attention_cuda"
# The paged kernel's operand type codes (csrc/paged_decode_attention.cu);
# the contiguous kernel takes the cache in q's type or in float8 e4m3.
_PAGED_Q = {torch.float32: 0, torch.bfloat16: 1}
_PAGED_KV = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
E4M3 = torch.float8_e4m3fn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class DecodePlan:
    """The split kernel's launch: ``tile_rows`` rows of K and V staged in
    shared memory per step, ``split_rows`` rows walked by one CTA (a
    whole number of pages when paged), ``splits`` spans per (sequence,
    kv head) pair, and the grid (B * Hkv, splits); the splits of a pair
    are one thread-block cluster and merge in its shared memory."""
    tile_rows: int
    split_rows: int
    splits: int
    grid: tuple[int, int]


def decode_plan(B: int, Hq: int, Hkv: int, cache_len: int, D: int, dtype,
                *, kv_dtype=None, page_size: int | None = None) -> DecodePlan:
    """The split and tile for a decode of q (B,Hq,D) in ``dtype`` against
    ``cache_len`` cache rows per sequence of ``kv_dtype`` (default
    ``dtype``; contiguous caches may also be float8 e4m3), paged when
    ``page_size`` is given.  From shapes alone:
    the pairs B * Hkv are split until the grid has ``TARGET_CTAS`` CTAs,
    at most ``MAX_SPLITS`` ways (a shape that has them already is not
    split).  A tile is 64 rows at a group of three or more q heads (a
    warp per head, so more rows keep the busy warps' lanes working) where
    the split is that long, else 32 (fewer shared bytes, more CTAs on an
    SM); when paged, a whole number of pages (a divisor of the page when
    a page has more rows).  Raises on what the kernels do not take."""
    name = _CONTIGUOUS if page_size is None else _PAGED
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    if dtype not in _PAGED_Q:
        raise TypeError(f"{name}: q must be float32 or bfloat16"
                        + ("" if page_size is None else
                           " with its head dim contiguous")
                        + f", got {dtype}")
    if Hkv < 1 or Hq % Hkv or not 1 <= Hq // Hkv <= MAX_GROUP:
        raise ValueError(f"{name}: {Hq} q heads over {Hkv} kv heads; the "
                         f"group must divide and be <= {MAX_GROUP}")
    if page_size is not None and kv_dtype not in _PAGED_KV:
        raise TypeError(f"{name}: pools must be float32, bfloat16 or int8, "
                        f"got {kv_dtype}")
    if page_size is None and kv_dtype not in (dtype, E4M3):
        raise TypeError(f"{name}: k and v must be {dtype} or "
                        f"{E4M3}, got {kv_dtype}")
    vec = 16 // torch.tensor([], dtype=kv_dtype).element_size()
    if D < 1 or D % vec or D > 32 * vec:
        raise ValueError(f"{name}: head dim {D} must be a multiple of {vec} "
                         f"up to {32 * vec}"
                         + ("" if page_size is None else
                            f" for {kv_dtype} pools"))
    want = min(MAX_SPLITS, _cdiv(TARGET_CTAS, B * Hkv))
    tile = 64 if Hq // Hkv >= 3 and _cdiv(cache_len, want) >= 64 else 32
    unit = tile
    if page_size is not None:
        if page_size < 1:
            raise ValueError(f"{name}: page size {page_size} must be >= 1")
        if page_size <= tile:
            tile = unit = page_size * (tile // page_size)
        else:
            tile = max(t for t in range(1, tile + 1) if page_size % t == 0)
            unit = page_size
    split_rows = unit * _cdiv(_cdiv(cache_len, want), unit)
    splits = _cdiv(cache_len, split_rows)
    return DecodePlan(tile, split_rows, splits, (B * Hkv, splits))


_LAUNCHERS = {(torch.float32, torch.float32): "decode_attention_f32",
              (torch.bfloat16, torch.bfloat16): "decode_attention_bf16",
              (torch.float32, E4M3): "decode_attention_f32_e4m3",
              (torch.bfloat16, E4M3): "decode_attention_bf16_e4m3"}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_float, ctypes.c_void_p]


def decode_attention_plain(q, k, v, kv_len, *, scale: float):
    """The kernel's function in plain PyTorch ops."""
    return decode_attention_ref(q, k, v, kv_len=kv_len, scale=scale)


def _check(q, k, v, kv_len) -> DecodePlan:
    if not q.is_cuda:
        raise RuntimeError(f"decode_attention_cuda needs CUDA tensors, got "
                           f"one on {q.device}")
    B, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"decode_attention_cuda: q {tuple(q.shape)} and "
                         f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not "
                         f"form (B,Hq,D) x (B,Hkv,S,D)")
    plan = decode_plan(B, Hq, k.shape[1], k.shape[2], D, q.dtype,
                       kv_dtype=k.dtype)
    vec = 16 // k.element_size()
    for name, t in (("k", k), ("v", v)):
        if t.dtype != k.dtype or t.device != q.device:
            raise TypeError(f"decode_attention_cuda: {name} must be "
                            f"{k.dtype} on {q.device}")
        if (t.stride(3) != 1 or t.data_ptr() % 16
                or any(t.stride(i) % vec for i in range(3))):
            raise ValueError(f"decode_attention_cuda: {name}'s rows must "
                             f"be contiguous and 16-byte aligned")
    if (kv_len.shape != (B,) or kv_len.dtype != torch.int32
            or not kv_len.is_contiguous() or kv_len.device != q.device):
        raise TypeError(f"decode_attention_cuda: kv_len must be a ({B},) "
                        f"int32 tensor on {q.device}")
    return plan


def decode_attention_cuda(q, k, v, kv_len, *, scale: float):
    """Launch the CUDA kernels: q (B,Hq,D), k and v (B,Hkv,S,D) with
    contiguous, 16-byte aligned rows (any other strides), kv_len (B,)
    int32 with every entry >= 1, all on the card; q float32 or bfloat16,
    k and v in q's type or float8 e4m3 (``torch.float8_e4m3fn``).  One
    launch on ``decode_plan``'s grid; ``launches`` counts it.
    Returns (B,Hq,D) in q's type.  Raises on a CPU tensor."""
    plan = _check(q, k, v, kv_len)
    B, Hq, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    dims = (ctypes.c_int * 8)(B, Hq, Hkv, S, D, plan.tile_rows,
                              plan.split_rows, plan.splits)
    strides = (ctypes.c_longlong * 10)(
        q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
        out.stride(0), out.stride(1))
    lib = load_library("decode_attention")
    fn = getattr(lib, _LAUNCHERS[q.dtype, k.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                 out.data_ptr(), dims, strides, float(scale), stream)
    check_launch(lib, "decode_attention", err)
    decode_attention_cuda.launches += 1
    return out


decode_attention_cuda.launches = 0
decode_attention_cuda.counters = ("launches",)


_PAGED_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                   + [ctypes.c_float, ctypes.c_void_p])


def paged_decode_attention_plain(q, k_pages, v_pages, page_table, kv_len, *,
                                 scale: float, k_scale=None, v_scale=None):
    """The paged kernel's function in plain PyTorch ops."""
    return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                      kv_len=kv_len, scale=scale,
                                      k_scale=k_scale, v_scale=v_scale)


def _check_paged(q, k_pages, v_pages, page_table, kv_len, k_scale,
                 v_scale) -> DecodePlan:
    name = _PAGED
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
    n_pages, page_size, Hkv, _ = k_pages.shape
    if (page_table.ndim != 2 or page_table.shape[0] != B
            or page_table.dtype != torch.int32
            or not page_table.is_contiguous()
            or page_table.device != q.device):
        raise TypeError(f"{name}: page_table must be a contiguous ({B}, "
                        f"pages_per_slot) int32 tensor on {q.device}")
    plan = decode_plan(B, Hq, Hkv, page_table.shape[1] * page_size, D,
                       q.dtype, kv_dtype=k_pages.dtype, page_size=page_size)
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
    if (kv_len.shape != (B,) or kv_len.dtype != torch.int32
            or not kv_len.is_contiguous() or kv_len.device != q.device):
        raise TypeError(f"{name}: kv_len must be a ({B},) int32 tensor on "
                        f"{q.device}")
    return plan


def paged_decode_attention_cuda(q, k_pages, v_pages, page_table, kv_len, *,
                                scale: float, k_scale=None, v_scale=None):
    """Launch the paged CUDA kernels: q (B,Hq,D) float32 or bfloat16 with
    D contiguous; k_pages and v_pages contiguous (n_pages, page_size,
    Hkv, D) pools in float32, bfloat16 or int8 (then k_scale and v_scale
    (n_pages,) float32); page_table (B, pages_per_slot) and kv_len (B,)
    int32, every kv_len >= 1 and every page the first kv_len rows touch
    mapped.  All on the card.  One launch on ``decode_plan``'s grid;
    ``launches`` counts it.  Returns (B,Hq,D) in q's type.  Raises on a
    CPU tensor."""
    plan = _check_paged(q, k_pages, v_pages, page_table, kv_len, k_scale,
                        v_scale)
    B, Hq, D = q.shape
    _, page_size, Hkv, _ = k_pages.shape
    out = torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)
    dims = (ctypes.c_int * 9)(B, Hq, Hkv, D, page_size, page_table.shape[1],
                              plan.tile_rows, plan.split_rows, plan.splits)
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
paged_decode_attention_cuda.counters = ("launches",)
