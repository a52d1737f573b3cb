"""RWKV6 WKV recurrence: the Hopper kernel and its plain version.

``wkv6_cuda`` replaces ``repro/kernels/rwkv6/kernel.py::wkv6_pallas``
(its ``pallas_call`` at line 79): the WKV6 recurrence of r, k, v, w (B,
L, H, D) with the per-channel bonus u (H, D), from an initial state s0
(B, H, D, D) or zero, returning y and the final state.  The source is
``csrc/wkv6.cu``: one CTA of D threads per (batch, head), thread j
holding column j of the state in registers, walking t in order with
each step's r, k, w row staged in shared memory, so every input byte is
read once -- the property the TPU kernel keeps its state in VMEM for.

What bounds it on an H100: about 5 D^2 f32 FLOP per step and head over
5 D values moved; at rwkv6-7b's prefill (L = 512, 64 heads of 64) 0.67
GFLOP over 22 MB, so the f32 rate bounds it.  64 CTAs of two warps use
half the card's SMs at batch 1.

``wkv6_plain`` computes the kernel's function step by step in f32
(``ref.wkv6_ref``).
"""
from __future__ import annotations

import ctypes

import torch

from ..common import check_launch, load_library
from .ref import wkv6_ref

__all__ = ["wkv6_cuda", "wkv6_plain", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128)   # the kernel's instantiations
_LAUNCHERS = {torch.float32: "wkv6_f32", torch.bfloat16: "wkv6_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 11


def wkv6_plain(r, k, v, w, u, *, s0=None):
    """The kernel's function in plain PyTorch ops, step by step in f32:
    (y in r's type, final state (B, H, D, D) f32)."""
    return wkv6_ref(r, k, v, w, u, s0=s0, return_state=True)


def _check(r, k, v, w, u, s0):
    name = "wkv6_cuda"
    if not r.is_cuda:
        raise RuntimeError(f"{name} needs CUDA tensors, got one on "
                           f"{r.device}")
    if r.dtype not in _LAUNCHERS:
        raise TypeError(f"{name}: r must be float32 or bfloat16, got "
                        f"{r.dtype}")
    B, L, H, D = r.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {HEAD_DIMS}")
    for label, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape or t.dtype != r.dtype or t.device != r.device:
            raise TypeError(f"{name}: {label} must be a {tuple(r.shape)} "
                            f"{r.dtype} tensor on {r.device}")
    for label, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {label}'s head dim must be "
                             f"contiguous")
    if u.shape != (H, D) or u.device != r.device:
        raise ValueError(f"{name}: u must be ({H}, {D}) on {r.device}")
    if s0 is not None and (s0.shape != (B, H, D, D) or s0.dtype
                           != torch.float32 or not s0.is_contiguous()
                           or s0.device != r.device):
        raise TypeError(f"{name}: s0 must be a contiguous ({B}, {H}, {D}, "
                        f"{D}) float32 tensor on {r.device}")


def wkv6_cuda(r, k, v, w, u, *, s0=None):
    """Launch the CUDA kernel: r, k, v, w (B,L,H,D) all float32 or all
    bfloat16 with D contiguous (any other strides) and D in
    ``HEAD_DIMS``; u (H,D) of any float type (read as f32); s0 None or
    (B,H,D,D) float32 contiguous; all on the card.  Returns (y (B,L,H,D)
    in r's type, final state (B,H,D,D) float32).  Raises on a CPU
    tensor."""
    _check(r, k, v, w, u, s0)
    B, L, H, D = r.shape
    uf = u.float().contiguous()
    y = torch.empty((B, L, H, D), dtype=r.dtype, device=r.device)
    s_out = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    dims = (ctypes.c_int * 4)(B, L, H, D)
    strides = (ctypes.c_longlong * 12)(
        *[t.stride(i) for t in (r, k, v, w) for i in range(3)])
    lib = load_library("wkv6")
    fn = getattr(lib, _LAUNCHERS[r.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 uf.data_ptr(), None if s0 is None else s0.data_ptr(),
                 y.data_ptr(), s_out.data_ptr(), dims, strides, stream)
    check_launch(lib, "wkv6", err)
    wkv6_cuda.launches += 1
    return y, s_out


wkv6_cuda.launches = 0
