"""Scheduled matmul: the Hopper kernels, their plan and their plain version.

``matmul_cuda`` replaces ``repro/kernels/matmul/kernel.py::matmul_pallas``
(its ``pallas_call`` at line 161): ``(M,K) x (K,N)`` with f32
accumulation and the epilogue bias -> activation -> bypass, in float32
or bfloat16 (every operand and the output in the one type, as the
reference writes ``out_dtype = a.dtype``).  The source is
``csrc/matmul.cu``; ragged M, N and K are masked in the kernels, never
padded in device memory (``repro/kernels/matmul/ops.py:57-69`` pads).

``matmul_plan`` picks one of three hand-written paths from the shape,
the type and the operands' 16-byte alignment, in plain Python:

- ``skinny`` (M <= 64): the LM decode projections and the CNN FC
  layers, bound by the weight bytes over HBM.  Split-K over CTAs, 64
  output columns a CTA, enough splits for about two CTAs per SM
  (``TARGET_CTAS``); mma.sync in bf16, SIMT FMAs in f32.  Partial sums
  go to an f32 workspace the wrapper allocates and a second kernel sums
  them in a fixed order, so a result repeats bit for bit.
- ``wgmma`` (bf16, M > 64): the LM prefill and chunk projections, bound
  by the tensor cores.  TMA + wgmma on 128 x 128 tiles.
- ``simt``: everything else (f32 at M > 64, bf16 with K or N not a
  multiple of 8, unaligned operands).

``b_transposed``: B is given as the contiguous (N, K) tensor whose
transpose the product takes (a tied LM head reads its (vocab, d_model)
embedding so), and the bf16 skinny and wgmma paths read it as it lies:
its rows are K whole 16-byte vectors, so N may be ragged (whisper-base's
51,865), and a store that pairs two columns falls back to single
elements where a row starts on an odd one.  ``b_transposed_launches``
counts those launches.  Anything else read transposed goes to simt on a
copy of B in (K, N) order.

The schedule's ``dataflow`` and ``block`` set the CTA raster of the
wgmma and simt paths (see the source); the skinny path reads each weight
byte once whatever the order and takes neither.  ``matmul_plain``
computes the same function with PyTorch ops.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from ...core.dataflow import Dataflow
from ..common import ACT_CODES, check_launch, load_library
from .ref import matmul_ref

__all__ = ["MatmulPlan", "matmul_cuda", "matmul_plain", "matmul_plan"]

_DATAFLOW_CODES = {Dataflow.MAPS_RESIDENT: 0, Dataflow.WEIGHTS_RESIDENT: 1,
                   Dataflow.OUTPUT_STATIONARY: 2}


def matmul_plain(a, b, *, bias=None, activation: str | None = None,
                 bypass=None, b_transposed: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch ops (a: (M,K), b: (K,N), or
    (N,K) with ``b_transposed``); the schedule's dataflow and block
    change the order of work, not the result, so it takes neither."""
    return matmul_ref(a, b.T if b_transposed else b, bias=bias,
                      activation=activation, bypass=bypass)


def launch_args(a, b, out, *, dataflow: Dataflow,
                block: tuple[int, int, int], bias=None,
                activation: str | None = None, bypass=None,
                b_transposed: bool = False) -> list:
    """Checks the operands and returns the simt and wgmma launchers'
    arguments after the five pointers' tensors and before the stream:
    M, K, N, the dataflow's code, the block's bm and bn, the activation's
    code.  ``b_transposed``: b is (N, K)."""
    if a.dtype not in _LAUNCHERS:
        raise TypeError(f"matmul_cuda: a must be float32 or bfloat16, got "
                        f"{a.dtype}")
    M, K = a.shape
    N = b.shape[0] if b_transposed else b.shape[1]
    want = {"a": (a, (M, K)), "b": (b, (N, K) if b_transposed else (K, N)),
            "out": (out, (M, N))}
    if bias is not None:
        want["bias"] = (bias, (N,))
    if bypass is not None:
        want["bypass"] = (bypass, (M, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != a.dtype:
            raise TypeError(f"matmul_cuda: {name} must be {a.dtype} "
                            f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"matmul_cuda: {name} must be contiguous on "
                             f"{a.device}")
    bm, _, bn = block
    return [M, K, N, _DATAFLOW_CODES[dataflow], bm, bn,
            ACT_CODES[activation]]


# The skinny path: about two CTAs per SM of the H100 (132 SMs) on every
# shape, 64 output columns a CTA, K sliced in multiples of 32 rows.
SM_COUNT = 132
TARGET_CTAS = 2 * SM_COUNT
SKINNY_MAX_M = 64
SKINNY_BN = 64
K_GRAIN = 32
WGMMA_TILE = (128, 128, 64)
SIMT_TILE = (16, 32, 128)


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """One launch: ``path`` ("skinny" | "wgmma" | "simt"), the CTA
    ``tile`` (rows, columns, K rows a stage), ``splits`` K slices of
    ``kchunk`` rows (the last may be short), and ``grid``, the CTAs along
    (M, N, K).  The simt path's OUTPUT_STATIONARY raster pads its grid to
    whole blocks of the schedule; ``grid`` counts the tiles."""
    path: str
    tile: tuple[int, int, int]
    splits: int
    kchunk: int
    grid: tuple[int, int, int]

    @property
    def ctas(self) -> int:
        m, n, k = self.grid
        return m * n * k

    def k_slices(self, K: int) -> list[tuple[int, int]]:
        """[begin, end) of each split's K rows."""
        return [(s * self.kchunk, min(K, (s + 1) * self.kchunk))
                for s in range(self.splits)]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def matmul_plan(M: int, K: int, N: int, dtype, *, aligned: bool = True,
                b_transposed: bool = False) -> MatmulPlan:
    """The path, tile, split count and grid for an (M,K) x (K,N) product
    in ``dtype``.  ``aligned``: every operand starts on 16 bytes.  The
    skinny and wgmma paths load 16-byte vectors (TMA rows for wgmma), so
    they need K and N whole vectors (multiples of 4 in f32, 8 in bf16).
    ``b_transposed``: B lies as (N, K), whose rows are K long, so the
    bf16 paths need K whole vectors and take any N; f32 goes to simt."""
    if dtype not in _LAUNCHERS:
        raise TypeError(f"matmul_cuda: a must be float32 or bfloat16, got "
                        f"{dtype}")
    vec = 16 // (4 if dtype == torch.float32 else 2)
    if b_transposed:
        fits = aligned and K % vec == 0 and dtype == torch.bfloat16
    else:
        fits = aligned and K % vec == 0 and N % vec == 0
    if fits and M <= SKINNY_MAX_M:
        if dtype == torch.float32:
            rows, bk = (8 if M <= 8 else 16), 32
        else:
            rows, bk = 16 * max(1, _cdiv(M, 16)), 64
        m_tiles, n_tiles = _cdiv(M, rows), _cdiv(N, SKINNY_BN)
        want = max(1, _cdiv(TARGET_CTAS, max(1, m_tiles * n_tiles)))
        kchunk = K_GRAIN * max(1, _cdiv(_cdiv(K, K_GRAIN), want))
        splits = max(1, _cdiv(K, kchunk))
        return MatmulPlan("skinny", (rows, SKINNY_BN, bk), splits, kchunk,
                          (m_tiles, n_tiles, splits))
    if fits and dtype == torch.bfloat16:
        bm, bn, _ = WGMMA_TILE
        return MatmulPlan("wgmma", WGMMA_TILE, 1, K,
                          (_cdiv(M, bm), _cdiv(N, bn), 1))
    bm, bn, _ = SIMT_TILE
    return MatmulPlan("simt", SIMT_TILE, 1, K,
                      (_cdiv(M, bm), _cdiv(N, bn), 1))


# The C launchers: matmul_<f32|bf16> (simt), matmul_skinny_<f32|bf16>,
# matmul_wgmma_bf16, and B read transposed matmul_<skinny|wgmma>_bt_bf16.
_LAUNCHERS = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _launcher(path: str, dtype, b_transposed: bool = False):
    lib = load_library("matmul")
    kind = "" if path == "simt" else f"{path}_"
    if b_transposed:
        kind += "bt_"
    fn = getattr(lib, f"matmul_{kind}{_LAUNCHERS[dtype]}")
    # Five operand pointers, then the skinny path's workspace and M, K, N,
    # kchunk, splits, act, or the others' M, K, N, dataflow, bm, bn, act;
    # then the stream.
    fn.argtypes = ([_P] * 6 + [_I] * 6 if path == "skinny"
                   else [_P] * 5 + [_I] * 7) + [_P]
    fn.restype = ctypes.c_int
    return lib, fn


def _ptr(t):
    return None if t is None else t.data_ptr()


def _aligned(*tensors) -> bool:
    return all(t is None or t.data_ptr() % 16 == 0 for t in tensors)


def matmul_cuda(a, b, *, dataflow: Dataflow = Dataflow.OUTPUT_STATIONARY,
                block: tuple[int, int, int] = (128, 128, 128), bias=None,
                activation: str | None = None, bypass=None,
                b_transposed: bool = False) -> torch.Tensor:
    """Launch the planned CUDA path on CUDA tensors: a (M,K), b (K,N) --
    or (N,K) with ``b_transposed``, the product then ``a @ b.T`` --
    bias (N,), bypass (M,N), all float32 or all bfloat16, and contiguous;
    ragged shapes are fine.  Raises on a CPU tensor.  Counts one launch
    in ``launches``, one in ``path_launches[plan.path]`` and, where the
    kernel reads b transposed, one in ``b_transposed_launches``."""
    if not a.is_cuda:
        raise RuntimeError(f"matmul_cuda needs CUDA tensors, got one on "
                           f"{a.device}")
    N = b.shape[0] if b_transposed else b.shape[1]
    out = torch.empty((a.shape[0], N), dtype=a.dtype, device=a.device)
    args = launch_args(a, b, out, dataflow=dataflow, block=block, bias=bias,
                       activation=activation, bypass=bypass,
                       b_transposed=b_transposed)
    M, K, N, df, bm, bn, act = args
    plan = matmul_plan(M, K, N, a.dtype,
                       aligned=_aligned(a, b, bias, bypass, out),
                       b_transposed=b_transposed)
    if b_transposed and plan.path == "simt":
        b, b_transposed = b.T.contiguous(), False   # simt reads (K, N)
    lib, fn = _launcher(plan.path, a.dtype, b_transposed)
    ptrs = [_ptr(a), _ptr(b), _ptr(bias), _ptr(bypass), _ptr(out)]
    if plan.path == "skinny":
        ws = (torch.empty(plan.splits * M * N, dtype=torch.float32,
                          device=a.device) if plan.splits > 1 else None)
        tail = [_ptr(ws), M, K, N, plan.kchunk, plan.splits, act]
    else:
        tail = args
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(*ptrs, *tail, stream)
    check_launch(lib, "matmul", err)
    matmul_cuda.launches += 1
    matmul_cuda.path_launches[plan.path] += 1
    matmul_cuda.b_transposed_launches += b_transposed
    return out


matmul_cuda.launches = 0
matmul_cuda.path_launches = {"skinny": 0, "wgmma": 0, "simt": 0}
matmul_cuda.b_transposed_launches = 0
matmul_cuda.counters = ("launches", "path_launches",
                        "b_transposed_launches")
