"""Mamba2 SSD scan: the Hopper kernel, its launch plan and its plain
version.

``mamba2_scan_cuda`` replaces
``repro/kernels/mamba2/kernel.py::mamba2_scan_pallas`` (its
``pallas_call`` at line 98): the selective state-space scan of x (Bt, L,
H, P) with per-step dt (Bt, L, H), per-head A (H,) and B, C (Bt, L, N)
shared across heads, from an initial state h0 (Bt, H, N, P) or zero,
returning y and the final state.  The source is ``csrc/mamba2_scan.cu``.

What bounds it on an H100: in the chunked (SSD) form a 64-step chunk is
four small products on the tensor cores and one pass over the operands
(zamba2-7b's prefill, L = 512, 112 heads, N = P = 64: about 17 MB), so at
batch 1 what costs is latency and filling the card.  The TPU kernel runs
the chunks of a head in order with the state in VMEM; here they run in
parallel (``ssd_plan``'s chunked path, three launches): (a) one CTA per
(chunk, head, batch) computes the chunk's local state on mma, (b) a pass
carries the (N, P) state over the chunks in order, elementwise, and (c)
one CTA per (chunk, head, batch) computes y from the chunk's masked decay
products and the state entering it, on mma, rounded once.  The products
run in 3xTF32 (f32 operands split into two TF32 parts; a bf16 operand is
exact and needs no split).  A decode tick takes the step path: one CTA
per (head, batch) over the state in shared memory.  No atomics: the same
bits run to run, and nothing is read on the host (graph-safe).

``mamba2_scan_plain`` computes the kernel's function step by step in f32
(``ref.mamba2_scan_ref`` without D-skip).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..common import check_launch, load_library
from .ref import mamba2_scan_ref

__all__ = ["SsdPlan", "ssd_plan", "mamba2_scan_cuda", "mamba2_scan_plain"]

CHUNK = 64                      # rows of a chunk (csrc/mamba2_scan.cu Q)
THREADS = 256                   # threads of every CTA
MAX_WIDTH = 128                 # P and N at most
STEP_MAX = 16                   # longest L the step path takes
_LAUNCHERS = {torch.float32: "mamba2_scan_f32",
              torch.bfloat16: "mamba2_scan_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 14


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad16(n: int) -> int:
    return 16 * _cdiv(n, 16)


@dataclass(frozen=True)
class SsdPlan:
    """One ``mamba2_scan_cuda`` call: ``path`` "step" (one kernel, a CTA
    per (head, batch), ``grid``) or "chunked" (``kernels`` = 3: the chunk
    states and the outputs on ``grid`` = (chunks, H, Bt), the state pass
    on ``pass_grid``); ``chunk`` rows a chunk, ``n_chunks`` of them; P
    and N padded to ``Pp`` and ``Np``; ``smem`` the shared bytes of the
    step kernel, or of kernels (a) and (c); ``cluster`` CTAs a cluster
    (1: the state passes through a launch of its own)."""
    path: str
    chunk: int
    n_chunks: int
    grid: tuple
    pass_grid: tuple
    cluster: int
    kernels: int
    Pp: int
    Np: int
    smem: tuple


def ssd_plan(Bt: int, L: int, H: int, P: int, N: int, dtype) -> SsdPlan:
    """The launch of a scan of x (Bt, L, H, P), B and C (Bt, L, N) in
    ``dtype``, from shapes alone: the step path for L <= ``STEP_MAX``
    (a decode tick: the state's bytes bound it), else the chunked path
    in chunks of ``CHUNK`` rows, the last one possibly short.  Raises on
    what the kernels do not take."""
    name = "mamba2_scan_cuda"
    if dtype not in _LAUNCHERS:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got "
                        f"{dtype}")
    if not (1 <= P <= MAX_WIDTH and 1 <= N <= MAX_WIDTH):
        raise ValueError(f"{name}: head dim P = {P} and state N = {N} must "
                         f"be 1..{MAX_WIDTH}")
    if L < 1 or Bt < 1 or H < 1:
        raise ValueError(f"{name}: empty scan (Bt, L, H) = ({Bt}, {L}, "
                         f"{H})")
    Pp, Np = _pad16(P), _pad16(N)
    if L <= STEP_MAX:
        smem = 4 * (N * P + L * (P + 2 * N + 1) + THREADS)
        return SsdPlan("step", L, 1, (H, Bt), (), 1, 1, Pp, Np, (smem, 0))
    nc = _cdiv(L, CHUNK)
    a = 4 * (CHUNK * (Pp + 8) + CHUNK * (Np + 8) + 4 * CHUNK)
    c = 4 * (CHUNK * (Np + 4) + CHUNK * max(Np + 4, CHUNK + 4)
             + CHUNK * (Pp + 8) + Np * (Pp + 8) + 4 * CHUNK)
    return SsdPlan("chunked", CHUNK, nc, (nc, H, Bt),
                   (_cdiv(N * P, THREADS), Bt * H), 1, 3, Pp, Np, (a, c))


def mamba2_scan_plain(x, dt, A, B, C, *, h0=None):
    """The kernel's function in plain PyTorch ops, step by step in f32:
    (y in x's type, final state (Bt, H, N, P) f32)."""
    return mamba2_scan_ref(x, dt, A, B, C, h0=h0, return_state=True)


def _check(x, dt, A, B, C, h0) -> SsdPlan:
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
    return ssd_plan(Bt, L, H, P, N, x.dtype)


def mamba2_scan_cuda(x, dt, A, B, C, *, h0=None):
    """Launch the CUDA kernels: x (Bt,L,H,P) and B, C (Bt,L,N) float32 or
    bfloat16 with the last dim contiguous (any other strides), dt (Bt,L,H)
    float32 with any strides, A (H,) float32, h0 None or (Bt,H,N,P)
    float32 contiguous, all on the card; any L.  ``ssd_plan``'s kernels
    (one or three) on the current stream; ``launches`` counts calls.
    Returns (y (Bt,L,H,P) in x's type, final state (Bt,H,N,P) float32).
    Raises on a CPU tensor."""
    plan = _check(x, dt, A, B, C, h0)
    Bt, L, H, P = x.shape
    N = B.shape[-1]
    dev = x.device
    y = torch.empty((Bt, L, H, P), dtype=x.dtype, device=dev)
    h_out = torch.empty((Bt, H, N, P), dtype=torch.float32, device=dev)
    states = totals = None
    if plan.path == "chunked":
        states = torch.empty((Bt, H, plan.n_chunks, N, P),
                             dtype=torch.float32, device=dev)
        totals = torch.empty((Bt, H, plan.n_chunks), dtype=torch.float32,
                             device=dev)
    vec = int(N * P % 4 == 0 and (h0 is None or h0.data_ptr() % 16 == 0))
    dims = (ctypes.c_int * 10)(Bt, L, H, P, N,
                               0 if plan.path == "step" else 1,
                               plan.n_chunks, plan.Pp, plan.Np, vec)
    smem = (ctypes.c_int * 2)(*plan.smem)
    strides = (ctypes.c_longlong * 10)(
        *x.stride()[:3], *dt.stride(), *B.stride()[:2], *C.stride()[:2])
    lib = load_library("mamba2_scan")
    fn = getattr(lib, _LAUNCHERS[x.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), None if h0 is None else h0.data_ptr(),
                 y.data_ptr(), h_out.data_ptr(),
                 None if states is None else states.data_ptr(),
                 None if totals is None else totals.data_ptr(), dims, smem,
                 strides, stream)
    check_launch(lib, "mamba2_scan", err)
    mamba2_scan_cuda.launches += 1
    return y, h_out


mamba2_scan_cuda.launches = 0
