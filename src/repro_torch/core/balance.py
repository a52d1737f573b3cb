"""Communication load balancing (paper §6.3, T4).

Snowflake has 4 load/store units; the paper shows (Table 3) that
splitting large DMA transfers into chunks spread evenly across units —
minimizing the percent-imbalance metric C_L = (L_max / mu_L - 1) * 100 —
recovers up to 1.66x, saturating once transfers fully overlap compute.

On TPU the "units" generalize to (a) DMA streams the Pallas pipeline can
keep in flight, (b) ICI links per mesh axis, and (c) experts in a MoE
layer (token routing is a load-balancing problem with the same metric).
This module provides the metric, a greedy LPT balancer, the transfer
splitter, and MoE capacity planning.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

__all__ = [
    "percent_imbalance",
    "assign_lpt",
    "split_transfer",
    "balance_transfers",
    "speedup_model",
    "moe_capacity",
]


def percent_imbalance(loads: Sequence[float]) -> float:
    """C_L = (L_max / mu_L - 1) * 100  (paper eq. 1)."""
    loads = list(loads)
    if not loads:
        return 0.0
    mu = sum(loads) / len(loads)
    if mu == 0:
        return 0.0
    return (max(loads) / mu - 1.0) * 100.0


def assign_lpt(items: Sequence[float], n_units: int) -> list[list[int]]:
    """Longest-processing-time-first greedy partition of item indices
    onto ``n_units`` units.  Classic 4/3-approximation; what the paper's
    compiler does when spreading kernel+maps loads over load units."""
    units: list[list[int]] = [[] for _ in range(n_units)]
    totals = [0.0] * n_units
    for idx in sorted(range(len(items)), key=lambda i: -items[i]):
        u = min(range(n_units), key=lambda j: totals[j])
        units[u].append(idx)
        totals[u] += items[idx]
    return units


def split_transfer(total_bytes: int, n_chunks: int,
                   granule: int = 512) -> list[int]:
    """Split one large transfer into ``n_chunks`` granule-aligned chunks
    (paper: 'better to break a single large load transaction into
    multiple smaller loads')."""
    if n_chunks <= 1 or total_bytes <= granule:
        return [total_bytes]
    per = round_to_granule(total_bytes / n_chunks, granule)
    chunks = [per] * (n_chunks - 1)
    last = total_bytes - per * (n_chunks - 1)
    if last <= 0:   # over-split; shrink chunk count
        return split_transfer(total_bytes, n_chunks - 1, granule)
    chunks.append(last)
    return chunks


def round_to_granule(x: float, granule: int) -> int:
    return max(granule, int(math.ceil(x / granule)) * granule)


@dataclass(frozen=True)
class BalanceResult:
    assignments: list[list[int]]   # unit -> chunk indices
    chunk_bytes: list[int]
    imbalance_before: float
    imbalance_after: float


def balance_transfers(transfers: Sequence[int], n_units: int,
                      granule: int = 512,
                      max_chunks_per_transfer: int = 8) -> BalanceResult:
    """Chunk + LPT-balance a set of transfers across units.

    The un-balanced baseline assigns whole transfers round-robin (the
    paper's 'single map load to a unit while distributing kernels').
    """
    before = [0.0] * n_units
    for i, t in enumerate(transfers):
        before[i % n_units] += t
    imb_before = percent_imbalance(before)

    total = sum(transfers)
    target = total / n_units if n_units else 0
    chunks: list[int] = []
    for t in transfers:
        n = 1
        if target > 0 and t > target:
            n = min(max_chunks_per_transfer, max(1, round(t / target)))
        chunks.extend(split_transfer(t, n, granule))
    assign = assign_lpt(chunks, n_units)
    after = [sum(chunks[i] for i in unit) for unit in assign]
    imb_after = percent_imbalance(after)
    if imb_after > imb_before:
        # LPT is a 4/3-approximation; keep the round-robin baseline when
        # it happens to be better (never regress — the paper's Table 3
        # compares against the unbalanced baseline).
        assign = [[i for i in range(len(transfers)) if i % n_units == u]
                  for u in range(n_units)]
        return BalanceResult(assign, list(transfers), imb_before,
                             imb_before)
    return BalanceResult(assign, chunks, imb_before, imb_after)


def speedup_model(imbalance_pct: float, compute_time: float,
                  balanced_load_time: float) -> float:
    """Execution-time model behind the paper's Table 3.

    Per-unit transfer time scales with (1 + C_L/100); transfers overlap
    compute (double buffering), so step time = max(compute, slowest
    unit).  Speedup is measured against the worst recorded imbalance —
    the saturation shape of Table 3 falls out of the max()."""
    load_time = balanced_load_time * (1.0 + imbalance_pct / 100.0)
    return max(compute_time, load_time)


# --- MoE capacity planning (T4 applied to expert parallelism) --------------------
@dataclass(frozen=True)
class MoECapacity:
    capacity_per_expert: int
    capacity_factor: float
    expected_imbalance_pct: float


def moe_capacity(tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float = 1.25,
                 granule: int = 8) -> MoECapacity:
    """Capacity-bounded dispatch sizing.  Routing concentrates load; the
    capacity factor bounds the worst-unit load exactly like the paper's
    chunk splitting bounds L_max."""
    mean = tokens * top_k / n_experts
    cap = int(math.ceil(mean * capacity_factor / granule)) * granule
    cap = max(granule, cap)
    exp_imb = (cap / max(mean, 1e-9) - 1.0) * 100.0
    return MoECapacity(cap, capacity_factor, exp_imb)
