"""Flash-attention backward: the Hopper kernels and their plain version.

``flash_attention_bwd_cuda`` replaces
``repro/kernels/flash_attention/bwd_kernel.py::flash_attention_bwd_pallas``
(its ``pallas_call``s at lines 175 and 202): (dq, dk, dv) of softmax
attention from the forward's output and per-row logsumexp, with the
forward's causal, window and ``kv_len`` masks and GQA.  The source is
``csrc/flash_attention_bwd.cu``: a dQ pass (one CTA per (b, q head,
64-row q tile), which also computes ``delta = rowsum(dO * O)``) and a
dK/dV pass (one CTA per (b, kv head, 64-row kv tile) walking its GQA
group's q tiles), so no atomics are needed and the result is
deterministic.  Both are launched by one call, on the current stream.

What bounds it on an H100: at the smollm-360m training shape (B = 8,
Hq = 15, Hkv = 5, S = 512, D = 64, causal) the function needs 5
products of 2 D FLOP per unmasked (q, k) pair (S, dP, dV, dK, dQ),
about 10 GFLOP, over about 42 MB of q, k, v, out, dO, lse, dq, dk and
dv in bf16: some 240 FLOP per byte, under the bf16 ridge (about 295),
so HBM bandwidth bounds it.  The two-pass split does 7 products (the
dQ pass recomputes S and dP) and moves a delta scratch vector besides;
that is its price for needing no atomics.

``flash_plan`` (``kernel.py``) picks the path as for the forward:
``mma`` for aligned bf16 (mma.sync with f32 accumulators; P and dS,
the f32 operands of dV, dK and dQ, enter their products split into
three bf16 parts that sum to them exactly, so the products sum the
plain version's own terms: 14 products of tensor work against the
function's 5),
``simt`` for f32 and the rest (f32 tiles and FMAs).

``flash_attention_bwd_plain`` computes the same function with PyTorch
ops (``ref.flash_bwd_ref``); the CPU path and the on-card comparisons
use it.
"""
from __future__ import annotations

import ctypes

import torch

from ..common import check_launch, load_library
from .kernel import aligned16, flash_plan
from .ref import flash_bwd_ref

__all__ = ["flash_attention_bwd_cuda", "flash_attention_bwd_plain"]

_LAUNCHERS = {("simt", torch.float32): "flash_attention_bwd_f32",
              ("simt", torch.bfloat16): "flash_attention_bwd_bf16",
              ("mma", torch.bfloat16): "flash_attention_bwd_mma_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_float] + [ctypes.c_int] * 3
             + [ctypes.c_void_p])


def flash_attention_bwd_plain(q, k, v, out, lse, do, *, scale: float,
                              causal: bool, window: int | None,
                              kv_len: int | None):
    """The kernel's function in plain PyTorch ops: (dq, dk, dv)."""
    return flash_bwd_ref(q, k, v, out, lse, do, scale=scale, causal=causal,
                         window=window, kv_len=kv_len)


def _check(q, k, v, out, lse, do):
    if not q.is_cuda:
        raise RuntimeError(f"flash_attention_bwd_cuda needs CUDA tensors, "
                           f"got one on {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention_bwd_cuda: q must be float32 or "
                        f"bfloat16, got {q.dtype}")
    B, Hq, Sq, D = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or Hq % k.shape[1] or out.shape != q.shape
            or do.shape != q.shape or lse.shape != (B, Hq, Sq)):
        raise ValueError(
            f"flash_attention_bwd_cuda: q/out/do {tuple(q.shape)}/"
            f"{tuple(out.shape)}/{tuple(do.shape)}, k/v {tuple(k.shape)}/"
            f"{tuple(v.shape)} and lse {tuple(lse.shape)} do not form "
            f"(B,Hq,Sq,D) x (B,Hkv,Skv,D) with lse (B,Hq,Sq), Hq % Hkv == 0")
    for name, t in (("k", k), ("v", v), ("out", out), ("do", do)):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError(f"flash_attention_bwd_cuda: {name} must be "
                            f"{q.dtype} on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention_bwd_cuda: {name}'s head dim "
                             f"must be contiguous")
    if q.stride(3) != 1:
        raise ValueError("flash_attention_bwd_cuda: q's head dim must be "
                         "contiguous")
    if (lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise TypeError("flash_attention_bwd_cuda: lse must be a contiguous "
                        f"float32 tensor on {q.device}")


def flash_attention_bwd_cuda(q, k, v, out, lse, do, *, scale: float,
                             causal: bool, window: int | None,
                             kv_len: int | None):
    """Launch the two backward passes: q, out, do (B,Hq,Sq,D), k and v
    (B,Hkv,Skv,D), all float32 or all bfloat16 on the card, any strides
    with D contiguous; lse (B,Hq,Sq) contiguous f32; D <= 128 (raises
    past it).
    Returns (dq, dk, dv), contiguous, in q's type, each rounded once from
    its f32 sum.  Raises on a CPU tensor.  Counts one launch in
    ``launches`` and one in ``path_launches[plan.path]``."""
    _check(q, k, v, out, lse, do)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    dq = torch.empty((B, Hq, Sq, D), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, Hkv, Skv, D), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    plan = flash_plan(q.shape, k.shape, q.dtype, backward=True,
                      aligned=aligned16(q, k, v, out, do, dq, dk, dv))
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    dims = (ctypes.c_int * 6)(B, Hq, Hkv, Sq, Skv, D)
    strides = (ctypes.c_longlong * 15)(
        *[t.stride(i) for t in (q, k, v, out, do) for i in range(3)])
    launch = (ctypes.c_int * 5)(plan.d_tile, *plan.grid, *plan.kv_grid)
    lib = load_library("flash_attention_bwd")
    fn = getattr(lib, _LAUNCHERS[(plan.path, q.dtype)])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dims, strides,
                 launch, float(scale), int(causal), int(window or 0),
                 Skv if kv_len is None else int(kv_len), stream)
    check_launch(lib, "flash_attention_bwd", err)
    flash_attention_bwd_cuda.launches += 1
    flash_attention_bwd_cuda.path_launches[plan.path] += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0
flash_attention_bwd_cuda.path_launches = {"mma": 0, "simt": 0}
flash_attention_bwd_cuda.counters = ("launches", "path_launches")
