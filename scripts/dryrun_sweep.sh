#!/bin/bash
# The dry-run's full sweep: every registry arch x shape x both meshes, one
# `python -m repro_torch.launch.dryrun` process per (arch, mesh), 8 at a
# time on the CPU, then `python -m repro_torch.launch.report` over all the
# records.  Run from the repo's root:  bash scripts/dryrun_sweep.sh [OUTDIR]
set -u
out=${1:-dryrun_sweep}
mkdir -p $out
export PYTHONPATH=src OMP_NUM_THREADS=1 CUDA_VISIBLE_DEVICES=
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null || true
echo "cores $(nproc --all)"
archs=$(python3 -c 'from repro_torch.configs import REGISTRY; print(" ".join(REGISTRY))')
t0=$(date +%s)
for a in $archs; do for m in single multi; do echo "$a $m"; done; done |
  xargs -P 8 -n 2 sh -c 's=$(date +%s); timeout 2000 python3 -m repro_torch.launch.dryrun --arch $0 --mesh $1 --out '$out'/$0.$1.jsonl > '$out'/$0.$1.log 2>&1; echo "$0 $1 rc=$? $(( $(date +%s) - s )) s"'
echo "sweep wall $(( $(date +%s) - t0 )) s"
cat $out/*.jsonl | awk '!seen[$0]++' > $out/all.jsonl
python3 -m repro_torch.launch.report $out/all.jsonl > $out/report.md
grep -c . $out/all.jsonl
grep -h FAILED $out/*.log || true
