"""Tile selection (paper §5.1 steps 3-4, T2).

The paper decomposes maps into output-row-strip tiles and kernels into
single-kernel tiles sized to the on-chip buffers, double buffered.  On
TPU the on-chip buffer is VMEM and the tile shape *is* the Pallas
BlockSpec; the pipeline emitter provides the double buffering, so the
tiler charges 2x for every streamed operand.

Key constraints carried over from the paper:
* tiles must fit the buffer (VMEM budget, incl. double-buffer factor);
* compute-unit alignment — the paper pads to the 16-wide vMAC; we pad
  matmul dims to the 128-wide MXU (``hw.mxu_dim``) and the (8,128)
  sublane/lane layout;
* bigger tiles amortize "bookkeeping" (here: fewer grid steps, better
  pipeline efficiency) but raise the buffer footprint and the overlap
  waste for convolutions (halo rows re-loaded per strip).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from .hw import HardwareModel

__all__ = [
    "round_up",
    "round_down_multiple",
    "pow2_candidates",
    "MatmulTiling",
    "select_matmul_tiles",
    "enumerate_matmul_tilings",
    "ConvTiling",
    "select_conv_row_strips",
    "enumerate_conv_tilings",
    "conv_tiling_from",
    "select_attention_blocks",
    "enumerate_attention_blocks",
    "virtual_strips_fit",
]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def round_down_multiple(x: int, m: int) -> int:
    return max(m, (x // m) * m)


def pow2_candidates(limit: int, base: int) -> list[int]:
    """base, 2*base, 4*base ... <= limit (always at least [base])."""
    out = [base]
    while out[-1] * 2 <= limit:
        out.append(out[-1] * 2)
    return out


# --- matmul ---------------------------------------------------------------------
@dataclass(frozen=True)
class MatmulTiling:
    bm: int
    bk: int
    bn: int
    vmem_bytes: int          # working set incl. double buffering + accumulator
    grid: tuple[int, int, int]   # (m, n, k) tile counts

    @property
    def tiles(self) -> int:
        m, n, k = self.grid
        return m * n * k


def matmul_vmem_bytes(bm: int, bk: int, bn: int, dtype_bytes: int,
                      *, stream_a: bool = True, stream_b: bool = True,
                      acc_bytes: int = 4) -> int:
    """VMEM working set for one grid step.

    Streamed operands are double buffered (x2) by the Pallas pipeline;
    resident operands are held once.  The accumulator lives in VMEM at
    f32 (``acc_bytes``).
    """
    a = bm * bk * dtype_bytes * (2 if stream_a else 1)
    b = bk * bn * dtype_bytes * (2 if stream_b else 1)
    c = bm * bn * max(acc_bytes, dtype_bytes) * 2   # out is always streamed
    return a + b + c


def select_matmul_tiles(M: int, K: int, N: int, dtype_bytes: int,
                        hw: HardwareModel, *,
                        favor: str = "balanced") -> MatmulTiling:
    """Pick (bm, bk, bn) for an output-stationary tiled matmul.

    ``favor`` skews the VMEM split between the maps (A) and weights (B)
    operands — the within-kernel face of the paper's Mloop/Kloop dial:

    * ``"maps"``   — large bm (A-tile reuse; kernels streamed more: Kloop)
    * ``"weights"``— large bn (B-tile reuse; maps streamed more: Mloop)
    * ``"balanced"`` — minimize refetch traffic (N/bn)*A + (M/bm)*B.
    """
    base = hw.mxu_dim
    budget = hw.vmem_budget()
    Mp, Kp, Np = (round_up(max(d, 1), base) for d in (M, K, N))

    mcap = hw.maps_buffer_bytes or budget
    wcap = hw.weights_buffer_bytes or budget
    best: tuple[float, MatmulTiling] | None = None
    for bm in pow2_candidates(min(Mp, 2048), base):
        for bn in pow2_candidates(min(Np, 2048), base):
            for bk in pow2_candidates(min(Kp, 4096), base):
                vmem = matmul_vmem_bytes(bm, bk, bn, dtype_bytes)
                if vmem > budget:
                    continue
                if (2 * bm * bk * dtype_bytes > mcap
                        or 2 * bk * bn * dtype_bytes > wcap):
                    continue
                grid = (math.ceil(Mp / bm), math.ceil(Np / bn),
                        math.ceil(Kp / bk))
                # Refetch traffic for output-stationary order (k innermost).
                a_bytes = Mp * Kp * dtype_bytes
                b_bytes = Kp * Np * dtype_bytes
                traffic = grid[1] * a_bytes + grid[0] * b_bytes
                if favor == "maps":
                    cost = grid[0] * b_bytes + 1e-6 * traffic
                elif favor == "weights":
                    cost = grid[1] * a_bytes + 1e-6 * traffic
                else:
                    cost = traffic
                # Prefer fewer grid steps on ties (pipeline efficiency);
                # prefer larger bk (longer traces, the paper's MAC-latency
                # hiding: more MAC work per bookkeeping slot).
                cost += grid[0] * grid[1] * grid[2] * 1e-3
                cost -= bk * 1e-6
                cand = MatmulTiling(bm, bk, bn, vmem, grid)
                if best is None or cost < best[0]:
                    best = (cost, cand)
    assert best is not None, "no feasible tiling (VMEM too small?)"
    return best[1]


def enumerate_matmul_tilings(M: int, K: int, N: int, dtype_bytes: int,
                             hw: HardwareModel) -> list[MatmulTiling]:
    """Every feasible output-stationary (bm, bk, bn) the chooser's own
    loops would consider — the autotuner's matmul candidate set (the
    resident-slab flavors are enumerated by
    ``dataflow.enumerate_matmul_candidates``, which combines both).
    Feasibility is exactly ``select_matmul_tiles``'s: VMEM budget plus
    the split maps/weights buffer caps."""
    base = hw.mxu_dim
    budget = hw.vmem_budget()
    Mp, Kp, Np = (round_up(max(d, 1), base) for d in (M, K, N))
    mcap = hw.maps_buffer_bytes or budget
    wcap = hw.weights_buffer_bytes or budget
    out: list[MatmulTiling] = []
    for bm in pow2_candidates(min(Mp, 2048), base):
        for bn in pow2_candidates(min(Np, 2048), base):
            for bk in pow2_candidates(min(Kp, 4096), base):
                vmem = matmul_vmem_bytes(bm, bk, bn, dtype_bytes)
                if vmem > budget:
                    continue
                if (2 * bm * bk * dtype_bytes > mcap
                        or 2 * bk * bn * dtype_bytes > wcap):
                    continue
                grid = (math.ceil(Mp / bm), math.ceil(Np / bn),
                        math.ceil(Kp / bk))
                out.append(MatmulTiling(bm, bk, bn, vmem, grid))
    return out


# --- attention blocks -------------------------------------------------------------
def select_attention_blocks(Sq: int, Skv: int, D: int, dtype_bytes: int,
                            hw: HardwareModel, *,
                            window: int | None = None,
                            page_size: int | None = None) -> tuple[int, int]:
    """Pick (block_q, block_kv) for flash attention — T2 applied to the
    attention score loop: the q tile, double-buffered k+v tiles, the f32
    accumulator and the (bq, bkv) score tile must fit the VMEM budget.
    This is the compiler's decision; the flash kernel wrapper
    (kernels/flash_attention/ops.py) defers to it, and the LM Program
    lowering pins the result into each ``flash_attention`` op.

    ``Sq == 1`` is the **decode regime**: one new query token against a
    KV cache.  There is no score-loop freedom — the cache is the only
    big operand — so block_q is 1 and block_kv is sized to stream the
    cache at full bandwidth (k+v double buffered).  One chooser for
    both regimes: kernels/decode_attention/ops.py defers here, and the
    LM decode-Program lowering pins the result into each
    ``decode_attention`` op.

    ``window`` (causal sliding window) caps the kv extent a query ever
    touches: no score-loop tile should outgrow the window, so the
    effective Skv is ``min(Skv, window)``.  For a windowed *decode*
    node the cache region itself is already window-sized (the §5.1
    rolling plan), so both arguments agree.

    ``page_size`` marks a **paged** decode node (the §5.1 paged plan):
    the KV rows live in fixed-size pool pages gathered through a
    per-slot page table, so the kv stream has no contiguity beyond one
    page — the natural (and only) kv block IS the page.  The chooser
    pins ``block_kv = page_size`` and the paged kernel's grid walks the
    table one page per step."""
    budget = hw.vmem_budget()
    if window is not None:
        Skv = min(Skv, window)
    if Sq == 1 and page_size is not None:
        return (1, page_size)
    if Sq == 1:
        bkv = 128
        for b in (256, 512, 1024, 2048, 4096):
            if b <= max(Skv, 128) and 4 * b * D * dtype_bytes <= budget:
                bkv = b
        return (1, bkv)
    best = (hw.lane, hw.lane)
    for bq in (128, 256, 512, 1024, 2048):
        if bq > max(Sq, 128):
            break
        for bkv in (128, 256, 512, 1024, 2048):
            if bkv > max(Skv, 128):
                break
            use = (bq * D * dtype_bytes                 # q tile
                   + 2 * 2 * bkv * D * dtype_bytes      # k+v double-buffered
                   + bq * D * 4 + 2 * bq * 128 * 4      # acc + m/l scratch
                   + bq * bkv * 4)                      # score tile
            if use <= budget:
                best = (bq, bkv)
    return best


def enumerate_attention_blocks(Sq: int, Skv: int, D: int, dtype_bytes: int,
                               hw: HardwareModel, *,
                               window: int | None = None,
                               page_size: int | None = None
                               ) -> list[tuple[int, int]]:
    """Every feasible (block_q, block_kv) pair under the same VMEM test
    ``select_attention_blocks`` applies — the autotuner's attention
    candidate set.  ``Sq == 1`` enumerates the decode regime: (1, bkv)
    for every cache-streaming block that fits.  A paged decode node has
    no block freedom at all (the page is the kv tile), so its candidate
    set is the singleton (1, page_size)."""
    budget = hw.vmem_budget()
    if window is not None:
        Skv = min(Skv, window)
    if Sq == 1 and page_size is not None:
        return [(1, page_size)]
    if Sq == 1:
        out = [(1, 128)]
        for b in (256, 512, 1024, 2048, 4096):
            if b <= max(Skv, 128) and 4 * b * D * dtype_bytes <= budget:
                out.append((1, b))
        return out
    pairs: list[tuple[int, int]] = [(hw.lane, hw.lane)]
    for bq in (128, 256, 512, 1024, 2048):
        if bq > max(Sq, 128):
            break
        for bkv in (128, 256, 512, 1024, 2048):
            if bkv > max(Skv, 128):
                break
            use = (bq * D * dtype_bytes
                   + 2 * 2 * bkv * D * dtype_bytes
                   + bq * D * 4 + 2 * bq * 128 * 4
                   + bq * bkv * 4)
            if use <= budget:
                pairs.append((bq, bkv))
    return sorted(set(pairs))


# --- conv row strips --------------------------------------------------------------
@dataclass(frozen=True)
class ConvTiling:
    out_rows: int            # output rows per maps tile (paper: row granularity)
    in_rows: int             # input rows needed incl. halo
    kernels_per_tile: int    # output channels per kernel tile
    vmem_bytes: int
    n_map_tiles: int
    n_kernel_tiles: int
    overlap_frac: float      # fraction of maps bytes re-loaded due to halos
    # Compiler decision: where the halo overlap lives.  "materialized"
    # duplicates augmented strips in HBM (Snowflake's single-burst-DMA
    # constraint); "virtual" keeps the whole per-image maps resident in
    # VMEM and gathers strips in-kernel — zero extra HBM copies.  Chosen
    # by a VMEM-residency test in select_conv_row_strips.
    strip_storage: str = "materialized"

    @property
    def grid(self) -> tuple[int, int]:
        return (self.n_map_tiles, self.n_kernel_tiles)


def virtual_strips_fit(H: int, W: int, C_in: int, kh: int, stride: int,
                       pad: int, dtype_bytes: int, hw: HardwareModel,
                       kernel_tile_bytes: int, out_tile_bytes: int) -> bool:
    """VMEM-residency test for zero-copy (virtual) strips.

    Virtual strips hand the kernel the *whole* padded per-image maps as
    one block (double buffered across the batch grid dimension) and
    slice strips out in-kernel, so the hardware must support random
    access into the resident buffer, and the full padded plane — not
    just one strip — must fit the maps budget alongside the streamed
    kernel tile and the f32 output accumulator.
    """
    if not hw.random_buffer_access:
        return False               # contiguous-DMA hardware (Snowflake)
    budget = hw.vmem_budget()
    mcap = hw.maps_buffer_bytes or budget
    Hp = H + 2 * pad + max(0, kh - stride)     # + worst-case bottom fill
    Wp = W + 2 * pad
    maps_bytes = Hp * Wp * C_in * dtype_bytes * 2      # dbl buf
    if maps_bytes > mcap:
        return False
    return maps_bytes + kernel_tile_bytes + out_tile_bytes <= budget


def _strip_candidate(H: int, W: int, C_in: int, C_out: int, kh: int,
                     kw: int, stride: int, pad: int, dtype_bytes: int,
                     hw: HardwareModel, batch: int,
                     out_rows: int) -> ConvTiling | None:
    """One materialized-storage candidate at the given strip height:
    the widest kernel tile that fits next to the maps strip, shrunk
    until the f32 output accumulator also fits — exactly the chooser's
    per-``out_rows`` step, shared with ``enumerate_conv_tilings`` so
    the search space and the analytic pick can never drift."""
    oh = (H + 2 * pad - kh) // stride + 1
    ow = (W + 2 * pad - kw) // stride + 1
    budget = hw.vmem_budget()
    mcap = hw.maps_buffer_bytes or budget
    wcap = hw.weights_buffer_bytes or budget
    kernel_bytes_each = C_in * kh * kw * dtype_bytes
    in_rows = min(H, (out_rows - 1) * stride + kh)
    maps_bytes = in_rows * W * C_in * dtype_bytes * 2              # dbl buf
    if maps_bytes > mcap:
        return None
    remaining = min(budget - maps_bytes, wcap)
    if remaining <= kernel_bytes_each * 2:
        return None
    kpt = min(C_out, remaining // (kernel_bytes_each * 2))
    kpt = max(1, min(kpt, C_out))
    # Align kernel-tile width to the compute unit when possible.
    if kpt >= hw.mxu_dim:
        kpt = round_down_multiple(kpt, hw.mxu_dim)
    # Shrink the kernel tile until the f32 output strip also fits.
    while kpt > 1:
        out_acc = out_rows * ow * kpt * 4
        if maps_bytes + kpt * kernel_bytes_each * 2 + out_acc <= budget:
            break
        kpt = max(1, kpt // 2)
    out_acc = out_rows * ow * kpt * 4
    vmem = maps_bytes + kpt * kernel_bytes_each * 2 + out_acc
    if vmem > budget:
        return None
    n_map = math.ceil(oh / out_rows) * batch
    n_ker = math.ceil(C_out / kpt)
    halo = max(0, in_rows - out_rows * stride)
    overlap = (halo * (math.ceil(oh / out_rows) - 1)) / max(H, 1)
    return ConvTiling(out_rows, in_rows, kpt, vmem, n_map, n_ker, overlap)


def _virtual_variant(t: ConvTiling, H: int, W: int, C_in: int, C_out: int,
                     kh: int, kw: int, stride: int, pad: int,
                     dtype_bytes: int, hw: HardwareModel
                     ) -> ConvTiling | None:
    """The zero-copy twin of a materialized tiling, or None when the
    whole padded per-image maps is not VMEM-resident."""
    ow = (W + 2 * pad - kw) // stride + 1
    kernel_bytes_each = C_in * kh * kw * dtype_bytes
    ker_tile = t.kernels_per_tile * kernel_bytes_each * 2
    out_tile = t.out_rows * ow * t.kernels_per_tile * 4
    if not virtual_strips_fit(H, W, C_in, kh, stride, pad, dtype_bytes, hw,
                              ker_tile, out_tile):
        return None
    Hp = H + 2 * pad + max(0, kh - stride)
    Wp = W + 2 * pad
    return dataclasses.replace(
        t, strip_storage="virtual",
        vmem_bytes=Hp * Wp * C_in * dtype_bytes * 2 + ker_tile + out_tile)


def select_conv_row_strips(H: int, W: int, C_in: int, C_out: int, kh: int,
                           kw: int, stride: int, pad: int,
                           dtype_bytes: int, hw: HardwareModel,
                           batch: int = 1) -> ConvTiling:
    """Row-strip, channel-major conv tiling (paper §2: strips lower the
    replicated-overlap bytes vs 2D block tiles).

    A maps tile holds ``in_rows`` full-width input rows across all input
    channels; a kernel tile holds ``kernels_per_tile`` complete kernels
    (single-kernel granularity, as in the paper).  Output strip is
    accumulated in VMEM.
    """
    oh = (H + 2 * pad - kh) // stride + 1
    ow = (W + 2 * pad - kw) // stride + 1
    kernel_bytes_each = C_in * kh * kw * dtype_bytes

    best: ConvTiling | None = None
    for out_rows in range(1, oh + 1):
        cand = _strip_candidate(H, W, C_in, C_out, kh, kw, stride, pad,
                                dtype_bytes, hw, batch, out_rows)
        if cand is None:
            break  # strips only grow from here
        # Objective: fewest total tile-loads weighted by overlap waste.
        def cost(t: ConvTiling) -> float:
            return (t.n_map_tiles * t.n_kernel_tiles
                    + t.overlap_frac * t.n_map_tiles * 10.0)
        if best is None or cost(cand) < cost(best):
            best = cand
    if best is None:
        # Degenerate: single output row at a time, one kernel each.
        in_rows = min(H, kh)
        best = ConvTiling(1, in_rows, 1,
                          in_rows * W * C_in * dtype_bytes * 2
                          + kernel_bytes_each * 2 + ow * 4,
                          oh * batch, C_out, 0.0)
    # Strip-storage decision (overlap re-fetch vs duplication): go
    # zero-copy when the whole padded per-image maps is VMEM-resident.
    virt = _virtual_variant(best, H, W, C_in, C_out, kh, kw, stride, pad,
                            dtype_bytes, hw)
    return virt if virt is not None else best


def enumerate_conv_tilings(H: int, W: int, C_in: int, C_out: int, kh: int,
                           kw: int, stride: int, pad: int, dtype_bytes: int,
                           hw: HardwareModel, batch: int = 1
                           ) -> list[ConvTiling]:
    """The autotuner's conv candidate set: every feasible row-strip
    height (with its derived kernel tile) in both storages the hardware
    admits.  Superset of ``select_conv_row_strips``'s pick — same
    per-``out_rows`` feasibility step, just not reduced to one winner."""
    oh = (H + 2 * pad - kh) // stride + 1
    out: list[ConvTiling] = []
    seen: set[tuple] = set()
    for out_rows in range(1, oh + 1):
        cand = _strip_candidate(H, W, C_in, C_out, kh, kw, stride, pad,
                                dtype_bytes, hw, batch, out_rows)
        if cand is None:
            break
        for t in (cand, _virtual_variant(cand, H, W, C_in, C_out, kh, kw,
                                         stride, pad, dtype_bytes, hw)):
            if t is None:
                continue
            key = (t.out_rows, t.kernels_per_tile, t.strip_storage)
            if key not in seen:
                seen.add(key)
                out.append(t)
    return out


def conv_tiling_from(H: int, W: int, C_in: int, C_out: int, kh: int,
                     kw: int, stride: int, pad: int, dtype_bytes: int,
                     hw: HardwareModel, *, out_rows: int,
                     kernels_per_tile: int,
                     strip_storage: str = "materialized",
                     batch: int = 1) -> ConvTiling:
    """Reconstruct a ConvTiling from pinned (out_rows, kernels_per_tile,
    strip_storage) — how a tuned-cache entry becomes a schedule without
    re-searching.  Validates the same feasibility constraints the
    analytic chooser enforces (maps/weights buffer caps, VMEM budget,
    virtual residency) and raises ``ValueError`` on violation, so a
    stale or hand-edited cache can never emit an unexecutable schedule."""
    oh = (H + 2 * pad - kh) // stride + 1
    ow = (W + 2 * pad - kw) // stride + 1
    if not 1 <= out_rows <= oh:
        raise ValueError(f"out_rows {out_rows} outside [1, {oh}]")
    if not 1 <= kernels_per_tile <= C_out:
        raise ValueError(
            f"kernels_per_tile {kernels_per_tile} outside [1, {C_out}]")
    budget = hw.vmem_budget()
    mcap = hw.maps_buffer_bytes or budget
    wcap = hw.weights_buffer_bytes or budget
    kernel_bytes_each = C_in * kh * kw * dtype_bytes
    in_rows = min(H, (out_rows - 1) * stride + kh)
    maps_bytes = in_rows * W * C_in * dtype_bytes * 2
    ker_tile = kernels_per_tile * kernel_bytes_each * 2
    out_acc = out_rows * ow * kernels_per_tile * 4
    if maps_bytes > mcap:
        raise ValueError(f"maps strip {maps_bytes}B exceeds the maps "
                         f"buffer cap {mcap}B")
    if ker_tile > wcap:
        raise ValueError(f"kernel tile {ker_tile}B exceeds the weights "
                         f"buffer cap {wcap}B")
    if maps_bytes + ker_tile + out_acc > budget:
        raise ValueError(f"working set {maps_bytes + ker_tile + out_acc}B "
                         f"exceeds the VMEM budget {budget}B")
    n_map = math.ceil(oh / out_rows) * batch
    n_ker = math.ceil(C_out / kernels_per_tile)
    halo = max(0, in_rows - out_rows * stride)
    overlap = (halo * (math.ceil(oh / out_rows) - 1)) / max(H, 1)
    t = ConvTiling(out_rows, in_rows, kernels_per_tile,
                   maps_bytes + ker_tile + out_acc, n_map, n_ker, overlap)
    if strip_storage == "virtual":
        virt = _virtual_variant(t, H, W, C_in, C_out, kh, kw, stride, pad,
                                dtype_bytes, hw)
        if virt is None:
            raise ValueError("virtual strips do not fit the VMEM budget "
                             "(or the hardware lacks random buffer access)")
        return virt
    return t
