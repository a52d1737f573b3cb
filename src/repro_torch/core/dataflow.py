"""Loop rearrangement — the Mloop/Kloop decision (paper §6.2, T3).

The paper's central bandwidth optimization: when neither the maps nor
the kernels of a layer fit on-chip, one of them must be streamed
repeatedly.  ``Kloop`` keeps a maps tile resident and re-streams every
kernel tile past it (kernels loaded once per maps tile); ``Mloop`` keeps
a kernel tile resident and re-streams the maps.  The compiler picks the
order whose *total bytes moved* is lower, per layer.

This module implements that decision at two levels:

1. **Kernel level** (VMEM vs HBM): exact traffic formulas for the three
   Pallas-realizable dataflows of a tiled matmul —

   * ``MAPS_RESIDENT``  (paper Kloop): an A-slab (bm x K) stays in VMEM,
     B streams once per m-tile.     traffic = A + ceil(M/bm) * B + C
   * ``WEIGHTS_RESIDENT`` (paper Mloop): a B-slab (K x bn) stays, A
     streams once per n-tile.       traffic = ceil(N/bn) * A + B + C
   * ``OUTPUT_STATIONARY`` (beyond-paper generalization): both operands
     tiled, k innermost.  traffic = ceil(N/bn)*A + ceil(M/bm)*B + C

2. **Distributed level** (HBM vs ICI — beyond-paper): for a sharded
   matmul, choose between *weight-gathered* execution (weights
   all-gathered to the data shards; the Kloop analogue across ICI) and
   *activation-gathered* execution (activations gathered / partial sums
   reduce-scattered; the Mloop analogue), by the same bytes-moved logic.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass

from .hw import HardwareModel, MeshDescriptor
from .tiling import (MatmulTiling, enumerate_matmul_tilings,
                     matmul_vmem_bytes, pow2_candidates, round_up,
                     select_matmul_tiles)

__all__ = [
    "Dataflow",
    "enumerate_matmul_candidates",
    "matmul_traffic",
    "materialization_roundtrip",
    "conv_strip_traffic",
    "choose_conv_dataflow",
    "DataflowDecision",
    "choose_matmul_dataflow",
    "DistStrategy",
    "DistDecision",
    "choose_dist_strategy",
]


class Dataflow(enum.Enum):
    MAPS_RESIDENT = "kloop"        # paper's Kloop: kernels re-streamed
    WEIGHTS_RESIDENT = "mloop"     # paper's Mloop: maps re-streamed
    OUTPUT_STATIONARY = "output_stationary"


def matmul_traffic(M: int, K: int, N: int, dtype_bytes: int,
                   dataflow: Dataflow, bm: int, bk: int, bn: int,
                   out_bytes_per_el: int | None = None) -> float:
    """Total HBM bytes moved for one matmul under the given dataflow.

    Mirrors the paper's Fig. 4 accounting: resident operand loaded once,
    streamed operand loaded once per resident tile, output written once.
    """
    ob = out_bytes_per_el if out_bytes_per_el is not None else dtype_bytes
    a = M * K * dtype_bytes
    b = K * N * dtype_bytes
    c = M * N * ob
    if dataflow is Dataflow.MAPS_RESIDENT:
        return a + math.ceil(M / bm) * b + c
    if dataflow is Dataflow.WEIGHTS_RESIDENT:
        return math.ceil(N / bn) * a + b + c
    return math.ceil(N / bn) * a + math.ceil(M / bm) * b + c


def materialization_roundtrip(maps_bytes: float,
                              overlap_frac: float) -> float:
    """Bytes to build the halo-augmented strip copy in DRAM: read the
    maps once + write the ``(1 + overlap)`` augmented layout.  Zero when
    strips don't overlap — the producer's natural output already *is*
    the strip layout then.  The single definition shared by
    ``conv_strip_traffic``, the schedule notes, and the strip-storage
    benchmark."""
    if overlap_frac <= 0.0:
        return 0.0
    return (2.0 + overlap_frac) * maps_bytes


def conv_strip_traffic(maps_bytes: float, weights_bytes: float,
                       out_bytes: float, *, n_map_tiles: int,
                       n_kernel_tiles: int, overlap_frac: float,
                       strip_storage: str = "materialized",
                       charge_materialization: bool = True
                       ) -> tuple[float, float]:
    """(kloop, mloop) HBM bytes for a row-strip conv under T3.

    The single source of truth for the strip-grid loop-order formulas —
    both the schedule compiler (core/schedule.py) and the kernel wrapper
    (kernels/conv2d/ops.py) call this; they must never drift apart.

    ``strip_storage`` is the compiler's overlap decision (paper vs TPU):

    * ``"materialized"`` — Snowflake's scheme: halo-augmented strips are
      duplicated in DRAM so the DMA engine issues single-burst loads.
      Every maps pass re-reads the ``(1 + overlap_frac)`` copy, and —
      because the augmented layout is *not* what the producing layer
      wrote — building it costs a round trip first: read the maps once
      and write the ``(1 + overlap_frac)`` augmented copy.  That round
      trip, ``(2 + overlap_frac) * maps_bytes``, is charged whenever the
      strips actually overlap; ``charge_materialization=False`` opts out
      and reproduces the conv-loop-only accounting (the paper's Fig. 4
      frame, which measures the conv's own streams).  Zero-overlap
      strips need no augmentation (the producer's layout already *is*
      the strip layout), so they are never charged.
    * ``"virtual"`` — zero-copy: the kernel gathers each strip from the
      un-duplicated maps with an in-kernel dynamic slice, so maps move
      exactly once per pass, and there is no materialization round trip
      at all.
    """
    dup = 1.0 + (overlap_frac if strip_storage == "materialized" else 0.0)
    roundtrip = 0.0
    if strip_storage == "materialized" and charge_materialization:
        roundtrip = materialization_roundtrip(maps_bytes, overlap_frac)
    kloop = roundtrip + maps_bytes * dup + n_map_tiles * weights_bytes \
        + out_bytes
    mloop = roundtrip + n_kernel_tiles * maps_bytes * dup + weights_bytes \
        + out_bytes
    return kloop, mloop


def choose_conv_dataflow(maps_bytes: float, weights_bytes: float,
                         out_bytes: float, *, n_map_tiles: int,
                         n_kernel_tiles: int, overlap_frac: float,
                         strip_storage: str = "materialized",
                         charge_materialization: bool = True
                         ) -> tuple[Dataflow, float, dict[str, float]]:
    """Pick the cheaper strip-grid loop order; returns
    (dataflow, traffic_bytes, {"kloop": ..., "mloop": ...})."""
    kloop, mloop = conv_strip_traffic(
        maps_bytes, weights_bytes, out_bytes, n_map_tiles=n_map_tiles,
        n_kernel_tiles=n_kernel_tiles, overlap_frac=overlap_frac,
        strip_storage=strip_storage,
        charge_materialization=charge_materialization)
    alts = {"kloop": kloop, "mloop": mloop}
    if kloop <= mloop:
        return Dataflow.MAPS_RESIDENT, kloop, alts
    return Dataflow.WEIGHTS_RESIDENT, mloop, alts


@dataclass(frozen=True)
class DataflowDecision:
    dataflow: Dataflow
    tiling: MatmulTiling
    traffic_bytes: float
    alternatives: dict   # dataflow name -> traffic (for logging / Fig 4)

    @property
    def arithmetic_intensity(self) -> float:
        return 1.0  # overwritten by callers when FLOPs known


def _resident_tiling(M: int, K: int, N: int, dtype_bytes: int,
                     hw: HardwareModel,
                     dataflow: Dataflow) -> MatmulTiling | None:
    """Largest feasible resident-slab tiling, or None if the slab can
    never fit (K too large for the VMEM budget)."""
    base = hw.mxu_dim
    budget = hw.vmem_budget()
    mcap = hw.maps_buffer_bytes or budget
    wcap = hw.weights_buffer_bytes or budget
    Kp = round_up(K, base)
    if dataflow is Dataflow.MAPS_RESIDENT:
        # A slab (bm x K) resident; B (K x bn) streamed; C (bm x bn).
        best = None
        for bm in pow2_candidates(min(round_up(M, base), 4096), base):
            for bn in pow2_candidates(min(round_up(N, base), 1024), base):
                vmem = matmul_vmem_bytes(bm, Kp, bn, dtype_bytes,
                                         stream_a=False)
                if (bm * Kp * dtype_bytes > mcap
                        or 2 * Kp * bn * dtype_bytes > wcap):
                    continue
                if vmem <= budget:
                    g = (math.ceil(M / bm), math.ceil(N / bn), 1)
                    t = MatmulTiling(bm, Kp, bn, vmem, g)
                    # bigger bm means fewer B re-streams -> strictly better
                    if best is None or (t.bm, t.bn) > (best.bm, best.bn):
                        best = t
        return best
    # WEIGHTS_RESIDENT: B slab (K x bn) resident; A streamed.
    best = None
    for bn in pow2_candidates(min(round_up(N, base), 4096), base):
        for bm in pow2_candidates(min(round_up(M, base), 1024), base):
            vmem = matmul_vmem_bytes(bm, Kp, bn, dtype_bytes, stream_b=False)
            if (Kp * bn * dtype_bytes > wcap
                    or 2 * bm * Kp * dtype_bytes > mcap):
                continue
            if vmem <= budget:
                g = (math.ceil(M / bm), math.ceil(N / bn), 1)
                t = MatmulTiling(bm, Kp, bn, vmem, g)
                if best is None or (t.bn, t.bm) > (best.bn, best.bm):
                    best = t
    return best


def choose_matmul_dataflow(M: int, K: int, N: int, dtype_bytes: int,
                           hw: HardwareModel, *,
                           allow_output_stationary: bool = True,
                           out_bytes_per_el: int | None = None
                           ) -> DataflowDecision:
    """Per-layer loop-order choice (the paper's §5.1 step-3 decision).

    Evaluates the bytes-moved of every feasible dataflow and returns the
    cheapest.  ``allow_output_stationary=False`` restricts the choice to
    the paper's two modes (used by the paper-faithful benchmarks)."""
    options: list[tuple[float, Dataflow, MatmulTiling]] = []
    alts: dict[str, float] = {}

    for df in (Dataflow.MAPS_RESIDENT, Dataflow.WEIGHTS_RESIDENT):
        t = _resident_tiling(M, K, N, dtype_bytes, hw, df)
        if t is not None:
            tr = matmul_traffic(M, K, N, dtype_bytes, df, t.bm, t.bk, t.bn,
                                out_bytes_per_el)
            options.append((tr, df, t))
            alts[df.value] = tr

    if allow_output_stationary or not options:
        t = select_matmul_tiles(M, K, N, dtype_bytes, hw)
        tr = matmul_traffic(M, K, N, dtype_bytes, Dataflow.OUTPUT_STATIONARY,
                            t.bm, t.bk, t.bn, out_bytes_per_el)
        options.append((tr, Dataflow.OUTPUT_STATIONARY, t))
        alts[Dataflow.OUTPUT_STATIONARY.value] = tr

    options.sort(key=lambda o: o[0])
    tr, df, t = options[0]
    return DataflowDecision(dataflow=df, tiling=t, traffic_bytes=tr,
                            alternatives=alts)


def enumerate_matmul_candidates(M: int, K: int, N: int, dtype_bytes: int,
                                hw: HardwareModel, *,
                                allow_output_stationary: bool = True,
                                out_bytes_per_el: int | None = None
                                ) -> list[tuple[Dataflow, MatmulTiling,
                                                float]]:
    """The autotuner's matmul search space: every feasible
    (dataflow, tiling) pair with its modeled traffic — the resident-slab
    flavors from ``_resident_tiling``'s own loops plus the full
    output-stationary (bm, bk, bn) grid.  Superset of what
    ``choose_matmul_dataflow`` picks from."""
    base = hw.mxu_dim
    budget = hw.vmem_budget()
    mcap = hw.maps_buffer_bytes or budget
    wcap = hw.weights_buffer_bytes or budget
    Kp = round_up(K, base)
    out: list[tuple[Dataflow, MatmulTiling, float]] = []

    for bm in pow2_candidates(min(round_up(M, base), 4096), base):
        for bn in pow2_candidates(min(round_up(N, base), 1024), base):
            vmem = matmul_vmem_bytes(bm, Kp, bn, dtype_bytes, stream_a=False)
            if (bm * Kp * dtype_bytes > mcap
                    or 2 * Kp * bn * dtype_bytes > wcap or vmem > budget):
                continue
            g = (math.ceil(M / bm), math.ceil(N / bn), 1)
            t = MatmulTiling(bm, Kp, bn, vmem, g)
            tr = matmul_traffic(M, K, N, dtype_bytes, Dataflow.MAPS_RESIDENT,
                                bm, Kp, bn, out_bytes_per_el)
            out.append((Dataflow.MAPS_RESIDENT, t, tr))
    for bn in pow2_candidates(min(round_up(N, base), 4096), base):
        for bm in pow2_candidates(min(round_up(M, base), 1024), base):
            vmem = matmul_vmem_bytes(bm, Kp, bn, dtype_bytes, stream_b=False)
            if (Kp * bn * dtype_bytes > wcap
                    or 2 * bm * Kp * dtype_bytes > mcap or vmem > budget):
                continue
            g = (math.ceil(M / bm), math.ceil(N / bn), 1)
            t = MatmulTiling(bm, Kp, bn, vmem, g)
            tr = matmul_traffic(M, K, N, dtype_bytes,
                                Dataflow.WEIGHTS_RESIDENT, bm, Kp, bn,
                                out_bytes_per_el)
            out.append((Dataflow.WEIGHTS_RESIDENT, t, tr))
    if allow_output_stationary:
        for t in enumerate_matmul_tilings(M, K, N, dtype_bytes, hw):
            tr = matmul_traffic(M, K, N, dtype_bytes,
                                Dataflow.OUTPUT_STATIONARY, t.bm, t.bk, t.bn,
                                out_bytes_per_el)
            out.append((Dataflow.OUTPUT_STATIONARY, t, tr))
    return out


# --- distributed level (beyond-paper) -------------------------------------------
class DistStrategy(enum.Enum):
    WEIGHT_GATHERED = "weight_gathered"       # FSDP-style: AG weights (Kloop/ICI)
    ACTIVATION_GATHERED = "activation_gathered"  # TP-style: AG acts / RS partials
    LOCAL = "local"                            # operands already local


@dataclass(frozen=True)
class DistDecision:
    strategy: DistStrategy
    ici_bytes_per_chip: float
    alternatives: dict
    chunks: int = 1            # collective split factor for overlap (T4)


def choose_dist_strategy(M_local: int, K: int, N: int, dtype_bytes: int,
                         mesh: MeshDescriptor, hw: HardwareModel, *,
                         axis: str = "model",
                         overlappable_flops: float | None = None
                         ) -> DistDecision:
    """Pick weight- vs activation-gathered execution for one sharded
    matmul, per-chip ICI bytes as the cost (the paper's bytes-moved logic
    lifted to the interconnect).

    ``M_local`` is the per-chip token count; weights are sharded over
    ``axis`` (size g).  Weight-gathered moves the missing (g-1)/g of the
    weight matrix; activation-gathered moves activations in + partial
    sums out (all-gather + reduce-scatter = 2 * (g-1)/g * act bytes).
    """
    g = mesh.axis_size(axis)
    if g <= 1:
        return DistDecision(DistStrategy.LOCAL, 0.0, {"local": 0.0})
    frac = (g - 1) / g
    w_bytes = frac * K * N * dtype_bytes              # AG of weights
    a_bytes = 2 * frac * M_local * K * dtype_bytes    # AG acts + RS partials
    alts = {"weight_gathered": w_bytes, "activation_gathered": a_bytes}
    if w_bytes <= a_bytes:
        strat, cost = DistStrategy.WEIGHT_GATHERED, w_bytes
    else:
        strat, cost = DistStrategy.ACTIVATION_GATHERED, a_bytes

    # T4: chunk the collective so it overlaps with compute.  Target chunk
    # transfer time ~= chunk compute time; clamp to the load-unit count.
    chunks = 1
    if overlappable_flops and cost > 0:
        link_bw = hw.ici_bandwidth * max(hw.ici_links_per_axis, 1)
        t_coll = cost / link_bw
        t_comp = overlappable_flops / hw.peak_flops
        if t_coll < t_comp:
            chunks = max(1, min(hw.load_units * 2,
                                int(round(t_comp / max(t_coll, 1e-12)))))
            chunks = min(chunks, 8)
        else:
            chunks = hw.load_units
    return DistDecision(strat, cost, alts, chunks=chunks)
