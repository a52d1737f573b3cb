"""Measured cost calibration — from roofline guess to fitted predictor.

Copied from ``repro/core/cost.py`` (pure Python), so a fit over the same
record dicts gives the same coefficients in either package.

The schedule compiler prices every layer with an analytic roofline,
``hw.exec_time(flops, bytes) = max(compute, memory)``.  That model has
the right *shape* (linear in flops and bytes) but made-up *constants*:
real kernels pay launch overhead, achieve a fraction of peak, and hide
different amounts of traffic.  This module closes the gap the way
byteprofile-style profilers do: take executor trace records (see
``runtime/executor.ExecutorTrace``; on the card, timed on the device
clock), and fit, per kernel kind,

    t_measured  ~=  alpha * flops  +  beta * traffic_bytes  +  gamma

by ordinary least squares.  ``alpha`` is an effective 1/FLOPs-rate,
``beta`` an effective 1/bandwidth, ``gamma`` the per-call overhead —
the same three quantities the roofline hard-codes, now measured.

Kinds with too few distinct records for a stable 3-parameter fit fall
back to a single multiplicative correction (``scale`` mode): the median
measured/modeled ratio applied to the analytic prediction.  Kinds never
seen at all pass the analytic prediction through unchanged, so a
``CostModel`` is always total: calibration refines, never breaks.
The family op kinds (``ssm_scan`` / ``wkv`` / ``moe_dispatch`` /
``cross_attention``) enter as ordinary kinds — fitted when their trace
records carry measurements, analytic passthrough otherwise; the
autotuner never *replays* them (``autotune.TUNABLE`` excludes them),
but their calibration still re-prices the schedule's exec_time.

The fitted model serializes to JSON and rides in the tuned-schedule
cache (``core/autotune.py``); ``compile_model(..., cost_model=...)``
re-prices every ``LayerSchedule.exec_time_s`` with it.
"""
from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field

__all__ = ["KindFit", "CostModel", "fit_cost_model", "error_table",
           "format_error_table"]

# Minimum records for a full 3-coefficient least-squares fit; below
# this the normal equations are under-determined (or fit noise) and the
# scale fallback is safer.
MIN_LSQ_RECORDS = 4


@dataclass(frozen=True)
class KindFit:
    """Calibration for one kernel kind.

    ``mode`` is ``"lsq"`` (alpha/beta/gamma valid) or ``"scale"``
    (only ``scale`` valid, applied to the analytic prediction).
    """
    mode: str
    alpha: float = 0.0          # s per flop
    beta: float = 0.0           # s per byte
    gamma: float = 0.0          # s per call
    scale: float = 1.0          # measured/modeled ratio (scale mode)
    n_records: int = 0
    mean_abs_rel_err: float = 0.0   # of the fit, on its own records


def _lsq3(rows: list[tuple[float, float, float]],
          ys: list[float]) -> tuple[float, float, float] | None:
    """Solve min ||X c - y|| for X rows (flops, bytes, 1) via the
    normal equations with Gaussian elimination — 3x3, no numpy needed.
    Returns None when the system is singular (e.g. all-identical rows).
    """
    # Column scaling keeps the 3x3 well conditioned (flops ~1e9 vs 1).
    sf = max(max(abs(r[0]) for r in rows), 1.0)
    sb = max(max(abs(r[1]) for r in rows), 1.0)
    xs = [(r[0] / sf, r[1] / sb, r[2]) for r in rows]
    ata = [[0.0] * 3 for _ in range(3)]
    aty = [0.0] * 3
    for x, y in zip(xs, ys):
        for i in range(3):
            aty[i] += x[i] * y
            for j in range(3):
                ata[i][j] += x[i] * x[j]
    # Gaussian elimination with partial pivoting.
    m = [row[:] + [atyv] for row, atyv in zip(ata, aty)]
    for col in range(3):
        piv = max(range(col, 3), key=lambda r: abs(m[r][col]))
        if abs(m[piv][col]) < 1e-18:
            return None
        m[col], m[piv] = m[piv], m[col]
        for r in range(3):
            if r != col:
                f = m[r][col] / m[col][col]
                for c in range(col, 4):
                    m[r][c] -= f * m[col][c]
    c = [m[i][3] / m[i][i] for i in range(3)]
    return c[0] / sf, c[1] / sb, c[2]


def _records_for_fit(records: list[dict]) -> dict[str, list[dict]]:
    by_kind: dict[str, list[dict]] = {}
    for r in records:
        if r.get("measured_time_s") is None:
            continue
        by_kind.setdefault(str(r["kind"]), []).append(r)
    return by_kind


def _fit_kind(recs: list[dict]) -> KindFit:
    ys = [float(r["measured_time_s"]) for r in recs]
    rows = [(float(r.get("flops", 0.0)),
             float(r.get("traffic_bytes", 0.0)), 1.0) for r in recs]
    distinct = len({(r[0], r[1]) for r in rows})
    coeffs = (_lsq3(rows, ys)
              if len(recs) >= MIN_LSQ_RECORDS and distinct >= 3 else None)
    if coeffs is not None:
        a, b, g = coeffs
        preds = [max(a * r[0] + b * r[1] + g, 0.0) for r in rows]
        # A fit that predicts non-positive time for real records is
        # extrapolating garbage; fall back to scale mode.
        if all(p > 0.0 for p in preds):
            err = _mean_abs_rel_err(preds, ys)
            return KindFit("lsq", alpha=a, beta=b, gamma=g,
                           n_records=len(recs), mean_abs_rel_err=err)
    ratios = sorted(float(r["measured_time_s"])
                    / max(float(r.get("modeled_time_s", 0.0)), 1e-12)
                    for r in recs)
    scale = ratios[len(ratios) // 2]     # median: robust to one outlier
    preds = [scale * max(float(r.get("modeled_time_s", 0.0)), 1e-12)
             for r in recs]
    return KindFit("scale", scale=scale, n_records=len(recs),
                   mean_abs_rel_err=_mean_abs_rel_err(preds, ys))


def _mean_abs_rel_err(preds: list[float], ys: list[float]) -> float:
    errs = [abs(p - y) / max(abs(y), 1e-12) for p, y in zip(preds, ys)]
    return sum(errs) / max(len(errs), 1)


@dataclass(frozen=True)
class CostModel:
    """Total function from (kind, flops, bytes, analytic guess) to
    calibrated seconds.  Immutable; build with ``fit_cost_model`` or
    ``CostModel.from_json``."""
    fits: dict[str, KindFit] = field(default_factory=dict)

    def predict(self, kind: str, flops: float, traffic_bytes: float,
                fallback_time_s: float) -> float:
        f = self.fits.get(kind)
        if f is None:
            return fallback_time_s
        if f.mode == "lsq":
            t = f.alpha * flops + f.beta * traffic_bytes + f.gamma
            if t > 0.0:
                return t
            # degenerate extrapolation -> analytic guess is safer
            return fallback_time_s
        return f.scale * fallback_time_s

    def to_json(self) -> str:
        return json.dumps(
            {k: dataclasses.asdict(v) for k, v in sorted(self.fits.items())},
            indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "CostModel":
        raw = json.loads(text)
        return cls({k: KindFit(**v) for k, v in raw.items()})


def fit_cost_model(records: list[dict]) -> CostModel:
    """Fit per-kind coefficients over executor trace records.

    Each record needs ``kind``, ``flops``, ``traffic_bytes``,
    ``modeled_time_s`` and ``measured_time_s`` (records without a
    measurement are skipped — e.g. interpret-mode traces used only for
    schema checks).
    """
    return CostModel({k: _fit_kind(v)
                      for k, v in _records_for_fit(records).items()})


def error_table(records: list[dict],
                model: CostModel | None = None) -> list[dict]:
    """Measured-vs-predicted summary per kernel kind.

    One row per kind: record count, mean |rel err| of the *analytic*
    model, and — when a fitted ``model`` is given — of the calibrated
    prediction, plus the calibration mode.  This is the table the
    replay harness (``runtime/replay.py``) and the tuner print.
    """
    out: list[dict] = []
    for kind, recs in sorted(_records_for_fit(records).items()):
        ys = [float(r["measured_time_s"]) for r in recs]
        analytic = [float(r.get("modeled_time_s", 0.0)) for r in recs]
        row = {
            "kind": kind,
            "n": len(recs),
            "mean_measured_us": 1e6 * sum(ys) / len(ys),
            "analytic_abs_rel_err": _mean_abs_rel_err(analytic, ys),
        }
        if model is not None:
            preds = [model.predict(kind, float(r.get("flops", 0.0)),
                                   float(r.get("traffic_bytes", 0.0)),
                                   float(r.get("modeled_time_s", 0.0)))
                     for r in recs]
            row["calibrated_abs_rel_err"] = _mean_abs_rel_err(preds, ys)
            f = model.fits.get(kind)
            row["mode"] = f.mode if f else "passthrough"
        out.append(row)
    return out


def format_error_table(rows: list[dict]) -> str:
    """Fixed-width rendering of ``error_table`` rows for CLI output."""
    if not rows:
        return "(no measured records)"
    hdr = (f"{'kind':<18} {'n':>4} {'measured_us':>12} "
           f"{'analytic_err':>13} {'calibrated_err':>15} {'mode':>8}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        cal = r.get("calibrated_abs_rel_err")
        lines.append(
            f"{r['kind']:<18} {r['n']:>4} {r['mean_measured_us']:>12.2f} "
            f"{r['analytic_abs_rel_err']:>12.1%} "
            + (f"{cal:>14.1%} " if cal is not None else f"{'-':>15} ")
            + f"{r.get('mode', '-'):>8}")
    return "\n".join(lines)
