"""Three-term roofline from a counted step (counterpart of
``repro/core/roofline.py``).

Per (arch x shape x mesh):

    compute_s    = flops / (chips * peak_FLOP/s)
    memory_s     = bytes / (chips * HBM_bw)
    collective_s = per-chip collective link bytes / link_bw

The reference takes the three counts from the optimized HLO text
(``core/hlo_analysis.py``); the port takes them from the step run once
under ``core/step_analysis.py::analyze_step``.  ``link_bytes`` is the
reference's ring-algorithm accounting, factor for factor.
``collective_stats_from_hlo`` has no counterpart: torch has no HLO, and
the analyzer accumulates a ``CollectiveStats``' numbers itself.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .hw import HardwareModel, TPU_V5E

__all__ = [
    "CollectiveStats",
    "RooflineReport",
    "roofline_report",
    "link_bytes",
    "DTYPE_BYTES",
    "TORCH_DTYPE_NAMES",
]

DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1, "f8e4m3fn": 1,
    "f8e5m2": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16,
}

# torch dtype -> its HLO name in DTYPE_BYTES.
TORCH_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2",
    torch.int16: "s16", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64", torch.complex64: "c64",
    torch.complex128: "c128",
}

COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
            "collective-permute")


def link_bytes(op: str, raw_bytes: float, group_size: int) -> float:
    """Per-chip link bytes of one collective moving ``raw_bytes`` (its
    result's bytes, as the reference counts every kind, reduce-scatter
    included) over a group of ``group_size``, by ring-algorithm
    accounting:

      all-reduce: 2 * (g-1)/g * bytes (reduce-scatter + all-gather)
      collective-permute: the full bytes
      all-gather, reduce-scatter, all-to-all: (g-1)/g * bytes

    A group of one moves nothing, except a permute: the reference charges
    a permute its bytes whatever the group (its HLO names no group for
    one), and so does this.  The port's rings post no hop at a group of
    one, so no permute is counted there."""
    if op not in COLL_OPS:
        raise ValueError(f"unknown collective {op!r}")
    if op == "collective-permute":
        return float(raw_bytes)
    g = group_size
    frac = (g - 1) / g if g > 1 else 0.0
    if op == "all-reduce":
        return 2.0 * frac * raw_bytes
    return frac * raw_bytes


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)        # op -> count
    op_bytes: dict = field(default_factory=dict)      # op -> raw result bytes
    link_bytes_per_chip: float = 0.0                  # ring-accounted

    def total_raw_bytes(self) -> float:
        return sum(self.op_bytes.values())


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_chips: int
    hlo_flops: float            # total across chips
    hlo_bytes: float
    coll_link_bytes: float      # per chip
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    coll_counts: dict
    step_time_s: float = 0.0
    notes: str = ""

    def as_row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.n_chips,
            "compute_ms": self.compute_s * 1e3,
            "memory_ms": self.memory_s * 1e3,
            "collective_ms": self.collective_s * 1e3,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "coll": dict(self.coll_counts),
        }


def roofline_report(*, arch: str, shape: str, mesh_name: str, n_chips: int,
                    stats, model_flops: float,
                    hw: HardwareModel = TPU_V5E,
                    cost_analysis: dict | None = None,
                    analytic_flops: float | None = None) -> RooflineReport:
    """Build the three-term report for one dry-run cell from a rank's
    counts (``stats``: a ``StepStats``, or anything with its ``flops``,
    ``hbm_bytes``, ``coll_link_bytes`` and ``coll_counts``).

    The counts are per rank, as the reference's per-device HLO: FLOPs and
    bytes are multiplied by ``n_chips`` for the cluster totals, link
    bytes stay per chip.  ``cost_analysis`` (a dict with "flops") is
    noted, as the reference notes XLA's."""
    notes = []
    flops = stats.flops * n_chips            # per rank -> cluster total
    byts = stats.hbm_bytes * n_chips
    if flops <= 0 and analytic_flops:
        flops = analytic_flops
        notes.append("flops=analytic")
    ca = cost_analysis or {}
    ca_flops = float(ca.get("flops", 0.0) or 0.0)
    if ca_flops:
        notes.append(f"cost_analysis_flops_per_dev={ca_flops:.3g}")

    link_bw = hw.ici_bandwidth * max(hw.ici_links_per_axis, 1)
    compute_s = flops / (n_chips * hw.peak_flops)
    memory_s = byts / (n_chips * hw.hbm_bandwidth)
    collective_s = stats.coll_link_bytes / link_bw

    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=lambda k: terms[k])
    useful = model_flops / flops if flops > 0 else 0.0
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_chips=n_chips,
        hlo_flops=flops, hlo_bytes=byts,
        coll_link_bytes=stats.coll_link_bytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops, useful_ratio=useful,
        coll_counts={k: round(v, 1) for k, v in stats.coll_counts.items()},
        step_time_s=max(compute_s, memory_s, collective_s),
        notes=";".join(notes))
