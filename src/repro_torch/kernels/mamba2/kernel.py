"""Mamba2 SSD scan: the Hopper kernel and its plain version.

``mamba2_scan_cuda`` replaces
``repro/kernels/mamba2/kernel.py::mamba2_scan_pallas`` (its
``pallas_call`` at line 98): the selective state-space scan of x (Bt, L,
H, P) with per-step dt (Bt, L, H), per-head A (H,) and B, C (Bt, L, N)
shared across heads, from an initial state h0 (Bt, H, N, P) or zero,
returning y and the final state.  The source is ``csrc/mamba2_scan.cu``:
one CTA per (batch, head) walks the sequence in chunks of at most
``MAX_CHUNK`` steps with the (N, P) f32 state in shared memory -- the
TPU kernel's 256-step chunk is a VMEM choice, and its 256 x 256 f32
decay tile would not fit the 227 KB a block may have.

What bounds it on an H100: about 5 N P f32 FLOP per step and head over
one pass of the operands; at zamba2-7b's prefill (L = 512, 112 heads,
N = P = 64) 1.2 GFLOP over 17 MB, so the f32 rate bounds it.  The first
kernel is a SIMT loop over shared memory, far from that bound.

``mamba2_scan_plain`` computes the kernel's function step by step in f32
(``ref.mamba2_scan_ref`` without D-skip).
"""
from __future__ import annotations

import ctypes

import torch

from ..common import check_launch, load_library
from .ref import mamba2_scan_ref

__all__ = ["mamba2_scan_cuda", "mamba2_scan_plain", "MAX_CHUNK"]

MAX_CHUNK = 64                  # steps per chunk the kernel's tiles hold
SMEM_LIMIT = 232448             # bytes of shared memory a block may have
_LAUNCHERS = {torch.float32: "mamba2_scan_f32",
              torch.bfloat16: "mamba2_scan_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 11


def mamba2_scan_plain(x, dt, A, B, C, *, h0=None):
    """The kernel's function in plain PyTorch ops, step by step in f32:
    (y in x's type, final state (Bt, H, N, P) f32)."""
    return mamba2_scan_ref(x, dt, A, B, C, h0=h0, return_state=True)


def _smem_bytes(N: int, P: int, Q: int) -> int:
    """Shared memory of one CTA (csrc/mamba2_scan.cu ``smem_floats``)."""
    return 4 * (N * P + Q * (N + 1) + Q * N + Q * P + Q * Q + 4 * Q)


def _check(x, dt, A, B, C, h0, Q):
    name = "mamba2_scan_cuda"
    if not x.is_cuda:
        raise RuntimeError(f"{name} needs CUDA tensors, got one on "
                           f"{x.device}")
    if x.dtype not in _LAUNCHERS:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    if (dt.shape != (Bt, L, H) or A.shape != (H,) or B.shape != (Bt, L, N)
            or C.shape != (Bt, L, N)):
        raise ValueError(f"{name}: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C "
                         f"{tuple(C.shape)} do not form (Bt,L,H,P), (Bt,L,H), "
                         f"(H,), (Bt,L,N), (Bt,L,N)")
    for label, t, dtype in (("B", B, x.dtype), ("C", C, x.dtype),
                            ("dt", dt, torch.float32),
                            ("A", A, torch.float32)):
        if t.dtype != dtype or t.device != x.device:
            raise TypeError(f"{name}: {label} must be {dtype} on {x.device}")
    for label, t in (("x", x), ("B", B), ("C", C)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: {label}'s last dim must be contiguous")
    if not A.is_contiguous():
        raise ValueError(f"{name}: A must be contiguous")
    if h0 is not None and (h0.shape != (Bt, H, N, P) or h0.dtype
                           != torch.float32 or not h0.is_contiguous()
                           or h0.device != x.device):
        raise TypeError(f"{name}: h0 must be a contiguous ({Bt}, {H}, {N}, "
                        f"{P}) float32 tensor on {x.device}")
    if _smem_bytes(N, P, Q) > SMEM_LIMIT:
        raise ValueError(f"{name}: state {N} x {P} with chunk {Q} needs "
                         f"{_smem_bytes(N, P, Q)} B of shared memory, over "
                         f"{SMEM_LIMIT}")


def mamba2_scan_cuda(x, dt, A, B, C, *, h0=None):
    """Launch the CUDA kernel: x (Bt,L,H,P) and B, C (Bt,L,N) float32 or
    bfloat16 with the last dim contiguous (any other strides), dt (Bt,L,H)
    float32 with any strides, A (H,) float32, h0 None or (Bt,H,N,P)
    float32 contiguous, all on the card.  The kernel walks chunks of
    ``min(MAX_CHUNK, L)`` steps, the last one possibly short.
    Returns (y (Bt,L,H,P) in x's type, final state (Bt,H,N,P) float32).
    Raises on a CPU tensor."""
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    Q = max(1, min(MAX_CHUNK, L))
    _check(x, dt, A, B, C, h0, Q)
    y = torch.empty((Bt, L, H, P), dtype=x.dtype, device=x.device)
    h_out = torch.empty((Bt, H, N, P), dtype=torch.float32, device=x.device)
    dims = (ctypes.c_int * 6)(Bt, L, H, P, N, Q)
    strides = (ctypes.c_longlong * 10)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2])
    lib = load_library("mamba2_scan")
    fn = getattr(lib, _LAUNCHERS[x.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), None if h0 is None else h0.data_ptr(),
                 y.data_ptr(), h_out.data_ptr(), dims, strides, stream)
    check_launch(lib, "mamba2_scan", err)
    mamba2_scan_cuda.launches += 1
    return y, h_out


mamba2_scan_cuda.launches = 0
