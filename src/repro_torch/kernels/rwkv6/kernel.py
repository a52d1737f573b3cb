"""RWKV6 WKV recurrence: the Hopper kernel, its launch plan and its plain
version.

``wkv6_cuda`` replaces ``repro/kernels/rwkv6/kernel.py::wkv6_pallas``
(its ``pallas_call`` at line 79): the WKV6 recurrence of r, k, v, w (B,
L, H, D) with the per-channel bonus u (H, D), from an initial state s0
(B, H, D, D) or zero, returning y and the final state.  The source is
``csrc/wkv6.cu``.

What bounds it on an H100: about 5 D^2 f32 FLOP per step and head over
5 D values moved (rwkv6-7b's prefill, L = 512, 64 heads of 64: 0.67
GFLOP over 22 MB), but the recurrence is a chain in t, which the TPU
kernel walks in order per (batch, head) with the state in VMEM.  Here
the sequence is cut into chunks that run in parallel (``wkv_plan``,
three launches): (a) each chunk's recurrence from a zero state, a CTA
per (64 value columns, chunk, batch and head), a thread holding 4
columns of every eighth key row, so a step's chain is D / 8 FMAs; (b)
the state carried over the chunks in order, S_c = diag(W_c) S_{c-1} +
dS_c; (c) each chunk's y completed with (r o a)^T S_{c-1}, a_t the
prefix products of w, on the tensor cores (3xTF32 for bf16 inputs, f64
for f32 ones).  Only products of w in (0, 1) appear, never a division,
so nothing overflows.  No atomics: the same bits run to run, graph-safe.

``wkv6_plain`` computes the kernel's function step by step in f32
(``ref.wkv6_ref``).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ..common import check_launch, load_library
from .ref import wkv6_ref

__all__ = ["WkvPlan", "wkv_plan", "wkv6_cuda", "wkv6_plain"]

CHUNK = 64                      # steps a chunk (csrc/wkv6.cu Q)
COLS = 64                       # value columns a CTA of kernel (a)
ROW_THREADS = 8                 # threads a column's key rows split over
SEGS = 4                        # segments of kernel (c)'s prefix scan
THREADS = 256                   # threads of kernels (b) and (c)
MAX_D = 128
_LAUNCHERS = {torch.float32: "wkv6_f32", torch.bfloat16: "wkv6_bf16"}
_ARGTYPES = [ctypes.c_void_p] * 15


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class WkvPlan:
    """One ``wkv6_cuda`` call, three kernels: (a) on ``local_grid`` =
    (column blocks, chunks, B * H) CTAs of ``COLS / 4 * ROW_THREADS``
    threads, each thread holding ``rows`` key rows of 4 columns; (b) the
    state pass on ``pass_grid``; (c) on ``out_grid`` = (chunks, H, B).
    ``chunk`` steps a chunk, ``n_chunks`` of them, the last possibly
    short; ``smem`` the shared bytes of (a) and (c); ``cluster`` CTAs a
    cluster (1: the state passes through a launch of its own)."""
    chunk: int
    n_chunks: int
    rows: int
    local_grid: tuple
    pass_grid: tuple
    out_grid: tuple
    cluster: int
    kernels: int
    smem: tuple


def wkv_plan(B: int, L: int, H: int, D: int, dtype) -> WkvPlan:
    """The launch of a WKV6 recurrence of r, k, v, w (B, L, H, D) in
    ``dtype``, from shapes alone: chunks of ``CHUNK`` steps, ceil(D /
    64) column blocks, ceil(D / 8) rows a thread rounded up to a power of
    two.  Any D of 1..128; raises on a larger one (ROADMAP C.2) and on
    what else the kernels do not take."""
    name = "wkv6_cuda"
    if dtype not in _LAUNCHERS:
        raise TypeError(f"{name}: r must be float32 or bfloat16, got "
                        f"{dtype}")
    if not 1 <= D <= MAX_D:
        raise ValueError(f"{name}: head dim {D} is past the kernel's "
                         f"1..{MAX_D} (a key row split over shared memory "
                         f"is ROADMAP C.2's open work)")
    if L < 1 or B < 1 or H < 1:
        raise ValueError(f"{name}: empty recurrence (B, L, H) = ({B}, {L}, "
                         f"{H})")
    rows = 2
    while rows * ROW_THREADS < D:
        rows *= 2
    nc = _cdiv(L, CHUNK)
    Dp = 16 * _cdiv(D, 16)
    smem = (4 * (3 * CHUNK * ROW_THREADS * rows + CHUNK * COLS),
            4 * (2 * CHUNK * (Dp + 4) + Dp * (Dp + 8) + SEGS * Dp))
    return WkvPlan(CHUNK, nc, rows, (_cdiv(D, COLS), nc, B * H),
                   (_cdiv(D * D, THREADS), B * H), (nc, H, B), 1, 3, smem)


def wkv6_plain(r, k, v, w, u, *, s0=None):
    """The kernel's function in plain PyTorch ops, step by step in f32:
    (y in r's type, final state (B, H, D, D) f32)."""
    return wkv6_ref(r, k, v, w, u, s0=s0, return_state=True)


def _check(r, k, v, w, u, s0) -> WkvPlan:
    name = "wkv6_cuda"
    if not r.is_cuda:
        raise RuntimeError(f"{name} needs CUDA tensors, got one on "
                           f"{r.device}")
    B, L, H, D = r.shape
    plan = wkv_plan(B, L, H, D, r.dtype)
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
    return plan


def wkv6_cuda(r, k, v, w, u, *, s0=None):
    """Launch the CUDA kernels: r, k, v, w (B,L,H,D) all float32 or all
    bfloat16 with D contiguous (any other strides), D of 1..128; u (H,D)
    of any float type (read as f32); s0 None or (B,H,D,D) float32
    contiguous; all on the card.  ``wkv_plan``'s three kernels on the
    current stream; ``launches`` counts calls.  Returns (y (B,L,H,D) in
    r's type, final state (B,H,D,D) float32).  Raises on a CPU tensor."""
    plan = _check(r, k, v, w, u, s0)
    B, L, H, D = r.shape
    dev = r.device
    uf = u.float().contiguous()
    y = torch.empty((B, L, H, D), dtype=r.dtype, device=dev)
    s_out = torch.empty((B, H, D, D), dtype=torch.float32, device=dev)
    y_local = torch.empty((B, L, H, D), dtype=torch.float32, device=dev)
    states = torch.empty((B, H, plan.n_chunks, D, D), dtype=torch.float32,
                         device=dev)
    decays = torch.empty((B, H, plan.n_chunks, D), dtype=torch.float32,
                         device=dev)
    dims = (ctypes.c_int * 6)(B, L, H, D, plan.n_chunks, plan.rows)
    smem = (ctypes.c_int * 2)(*plan.smem)
    strides = (ctypes.c_longlong * 12)(
        *[t.stride(i) for t in (r, k, v, w) for i in range(3)])
    lib = load_library("wkv6")
    fn = getattr(lib, _LAUNCHERS[r.dtype])
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                 uf.data_ptr(), None if s0 is None else s0.data_ptr(),
                 y.data_ptr(), s_out.data_ptr(), y_local.data_ptr(),
                 states.data_ptr(), decays.data_ptr(), dims, smem, strides,
                 stream)
    check_launch(lib, "wkv6", err)
    wkv6_cuda.launches += 1
    return y, s_out


wkv6_cuda.launches = 0
wkv6_cuda.counters = ("launches",)
