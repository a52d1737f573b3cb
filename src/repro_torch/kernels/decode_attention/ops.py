"""Public decode-attention wrapper and the shared ring rules
(counterpart of ``repro/kernels/decode_attention/ops.py``).

The cache operand is a **ring buffer**: callers that decode past the
cache length (a rolling full-length cache, or a sliding-window cache
sized ``W = min(max_len, attn_window)``) write the new token's K/V at
``pos % S`` and pass ``kv_len = ring_kv_len(pos, S)`` -- the last
``min(pos + 1, S)`` rows are then valid and everything at ring slots
``>= kv_len`` is masked out (the CUDA kernel does not read it).  Row
order inside the ring does not matter: RoPE bakes each row's absolute
position into its key, and softmax attention is permutation-invariant
over KV rows.

``paged_decode_attention`` is the same decode against the §5.1 paged
plan: the ring rules apply through a page table (``gather_pages`` is
the indirection rule).
"""
from __future__ import annotations

import torch

from ..common import use_kernel
from .kernel import (decode_attention_cuda, decode_plan,
                     paged_decode_attention_cuda)
from .ref import (decode_attention_ref, gather_pages,
                  paged_decode_attention_ref)

__all__ = ["decode_attention", "paged_decode_attention", "gather_pages",
           "ring_kv_len", "ring_positions", "launch_key"]


def ring_positions(length, cache_len: int, seq_len: int, device=None):
    """Source position for every ring slot of a rolling cache holding
    the last ``min(length, cache_len)`` of ``seq_len`` computed rows:
    slot ``j`` holds the latest position ``p < length`` with ``p %
    cache_len == j``.  Returns (cache_len,) int64 gather indices into
    the full (seq_len, ...) row stack.

    Slots with no valid position (j >= length) fall out of range and
    are clipped -- they *duplicate* an early row, not hold zeros.  That
    is safe because such slots sit at ring indices ``>=
    ring_kv_len(length - 1, cache_len)`` and decode overwrites slot
    ``pos % cache_len`` at the exact tick ``ring_kv_len`` first admits
    it, so a duplicate is never attended.  THE ring-layout rule of the
    prefill cache write (runtime/executor.py::_write_prefill_cache).
    ``length`` is an int or a (1,) int tensor on ``device`` (the
    graph-safe form: no host read)."""
    j = torch.arange(cache_len, device=device)
    last = torch.as_tensor(length, device=device) - 1
    p = j + torch.div(last - j, cache_len, rounding_mode="floor") * cache_len
    return p.clamp(0, seq_len - 1)


def ring_kv_len(pos: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Valid-row count of a rolling (ring) KV cache after the write at
    ``pos % cache_len`` has landed: the last ``min(pos + 1, cache_len)``
    tokens are attendable, older rows have been evicted by overwrite."""
    return (pos + 1).clamp(max=cache_len)


def launch_key(q_shape, kv_shape, dtype, kv_dtype=None) -> tuple:
    """What one ``decode_attention`` call on CUDA tensors launches for q
    (B,Hq,D) against a (B,Hkv,S,D) cache of ``kv_dtype`` (default
    ``dtype``): two calls with equal keys make the same launch.  The
    kernel takes no block (``decode_plan`` splits by shapes alone), so
    every ``block_kv`` of the schedule is this one launch."""
    B, Hq, D = q_shape
    Hkv, S = kv_shape[1], kv_shape[2]
    kv_dtype = dtype if kv_dtype is None else kv_dtype
    return ("decode_attention", str(dtype), str(kv_dtype), tuple(q_shape),
            tuple(kv_shape), decode_plan(B, Hq, Hkv, S, D, dtype,
                                         kv_dtype=kv_dtype))


def decode_attention(q, k, v, *, kv_len=None, scale: float | None = None,
                     impl: str = "auto") -> torch.Tensor:
    """Single-token decode: q (B,Hq,D) vs cache (B,Hkv,S,D); kv_len (B,)
    int32 or None for the full cache.

    The schedule's ``block_kv`` is a TPU VMEM block (the reference pads
    the cache to it); the CUDA kernel walks the live rows themselves and
    reads nothing past ``kv_len``, so it takes no block and the cache is
    never padded or copied."""
    B, Hq, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    if kv_len is None:
        kv_len = torch.full((B,), k.shape[2], dtype=torch.int32,
                            device=q.device)
    if not use_kernel(impl, q):
        return decode_attention_ref(q, k, v, kv_len=kv_len, scale=scale)
    return decode_attention_cuda(q, k, v, kv_len.to(torch.int32), scale=scale)


def paged_decode_attention(q, k_pages, v_pages, page_table, *, kv_len,
                           scale: float | None = None, k_scale=None,
                           v_scale=None, impl: str = "auto") -> torch.Tensor:
    """Single-token decode against a **paged** KV cache: q (B, Hq, D) vs
    pools (n_pages, page_size, Hkv, D) addressed through ``page_table``
    (B, pages_per_slot) int32.

    Slot ``b``'s virtual rows are its table row flattened (``cache_len =
    pages_per_slot * page_size``), and the ring rules apply through the
    table: callers pass ``kv_len = ring_kv_len(pos, cache_len)`` and
    write the new row at virtual row ``pos % cache_len``.  int8 pools
    carry one float32 scale per page (``k_scale`` / ``v_scale``).  There
    is no ``block_kv``: the block is the page (core/tiling.py pins
    ``block_kv == page_size`` for paged decode ops)."""
    B, Hq, D = q.shape
    scale = scale if scale is not None else D ** -0.5
    if kv_len is None:
        kv_len = torch.full((B,), page_table.shape[1] * k_pages.shape[1],
                            dtype=torch.int32, device=q.device)
    if not use_kernel(impl, q):
        return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                          kv_len=kv_len, scale=scale,
                                          k_scale=k_scale, v_scale=v_scale)
    return paged_decode_attention_cuda(
        q, k_pages, v_pages, page_table.to(torch.int32),
        kv_len.to(torch.int32), scale=scale, k_scale=k_scale,
        v_scale=v_scale)
