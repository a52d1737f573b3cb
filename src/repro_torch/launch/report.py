"""Render the roofline table (EXPERIMENTS.md §Roofline) from a dry-run
results JSONL (counterpart of ``repro/launch/report.py``, the same text
for the same file: either package's ``launch/dryrun.py`` writes it).
``python -m repro_torch.launch.report dryrun_results.jsonl``."""
from __future__ import annotations

import json
import sys


def load(path: str) -> list[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return rows


def fmt_ms(x: float) -> str:
    if x >= 100_000:
        return f"{x/1000:.0f}s"
    if x >= 1000:
        return f"{x/1000:.2f}s"
    if x >= 1:
        return f"{x:.1f}ms"
    return f"{x*1000:.0f}us"


def roofline_table(rows: list[dict], mesh: str = "16x16") -> str:
    out = ["| arch | shape | compute | memory | collective | dominant | "
           "MODEL/HLO flops | step bound |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("skipped") or "error" in r or r.get("mesh") != mesh:
            continue
        step = max(r["compute_ms"], r["memory_ms"], r["collective_ms"])
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_ms(r['compute_ms'])} "
            f"| {fmt_ms(r['memory_ms'])} | {fmt_ms(r['collective_ms'])} "
            f"| {r['dominant']} | {r['useful_ratio']:.2f} "
            f"| {fmt_ms(step)} |")
    return "\n".join(out)


def dryrun_table(rows: list[dict]) -> str:
    out = ["| arch | shape | mesh | compile | HLO GFLOPs/chip | "
           "coll bytes/chip | args/chip | temp/chip |",
           "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("skipped") or "error" in r:
            continue
        m = r.get("memory_analysis", {})
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compile_s']}s "
            f"| {r['hlo_flops']/r['chips']/1e9:.1f} "
            f"| {r['coll_link_bytes_per_chip']/1e6:.0f} MB "
            f"| {(m.get('argument_size_in_bytes') or 0)/1e9:.2f} GB "
            f"| {(m.get('temp_size_in_bytes') or 0)/1e9:.2f} GB |")
    skips = [r for r in rows if r.get("skipped")]
    if skips:
        out.append("")
        out.append("Skipped cells (per assignment rules):")
        for r in skips:
            out.append(f"* {r['arch']} x {r['shape']}: {r['reason']}")
    return "\n".join(out)


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else "dryrun_results.jsonl"
    rows = load(path)
    print("## Roofline (single-pod 16x16, 256 chips)\n")
    print(roofline_table(rows, "16x16"))
    print("\n## Roofline (multi-pod 2x16x16, 512 chips)\n")
    print(roofline_table(rows, "2x16x16"))
    print("\n## Dry-run records\n")
    print(dryrun_table(rows))


if __name__ == "__main__":
    main()
