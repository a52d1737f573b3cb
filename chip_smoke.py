#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and
``nvcc``; imports torch, numpy and ``repro_torch`` only.  Any failure
exits non-zero before the last line is printed.  Phases:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build every kernel from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, in parallel) and print the build time;
3. every distinct conv and FC op of the alexnet-owt and resnet18
   Programs at batch 8, on real activations (the plain forward's),
   through the kernel's wrapper and its plain version: max |err|
   (atol = rtol = 1e-4: f32 sums in another order over reductions of up
   to 9216 terms), and the median of 20 CUDA-event timings after 3
   warm-up calls of the kernel, the plain version, and the library
   yardstick (cuDNN ``F.conv2d`` or ``torch.addmm``, plus the same
   epilogue), with ``bound_ms`` = max(FLOPs / f32 peak, bytes / HBM
   rate) from the data sheet of the card named;
4. the main path: ``repro_torch.launch.serve`` serves 20 alexnet-owt
   images at full width with 8 slots on the kernels; every request must
   be served, its class must equal the plain path's on the card (rows
   whose top-2 logit gap exceeds 1e-4), and each launch counter must
   equal ticks x ops of that kind; then one resnet18 batch-8 forward,
   kernels against plain;
5. a ``kernels`` JSON line: per kernel, its launches on the main path,
   the max error over every checked op, and the times and bound summed
   over one alexnet-owt batch-8 tick (each op of the Program once);
6. the last line: ``{"ok": true, "device": {...}}``.

TF32 is switched off for cuDNN and cuBLAS, so the plain versions and
the library yardsticks compute in full f32 like the kernels.  Inputs are
not flushed from the 50 MB L2 between timed calls.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-4
SLOTS, REQUESTS, SEED = 8, 20, 0
# f32 (non-tensor) peak FLOP/s and HBM bytes/s by card name: NVIDIA's
# data sheet for the H100 SXM part at 700 W.  Another card has no entry
# here and the script stops rather than bound it by a wrong peak.
PEAKS = {"NVIDIA H100 80GB HBM3": (67e12, 3.35e12)}
REPLACES = {"conv2d_virtual": "src/repro/kernels/conv2d/kernel.py:241",
            "matmul": "src/repro/kernels/matmul/kernel.py:79"}
SOURCES = {"conv2d_virtual": "src/repro_torch/kernels/csrc/conv2d.cu",
           "matmul": "src/repro_torch/kernels/csrc/matmul.cu"}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(got, want) -> float:
    import torch
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"kernel output {tuple(got.shape)} not finite or not "
             f"{tuple(want.shape)}")
    err = (got - want).abs()
    if not bool((err <= TOL + TOL * want.abs()).all()):
        fail(f"kernel disagrees with its plain version: max |err| "
             f"{err.max().item():.3e}")
    return err.max().item()


def op_cases(cfg, batch, device):
    """Walk the Program on the plain path; yield each conv / matmul op
    with the operands the executor hands it."""
    import torch
    from repro_torch.models import cnn, init_params
    from repro_torch.runtime.executor import walk
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_params(cnn.param_defs(cfg), gen, device)
    program = cnn.compile_program(cfg, batch=batch)
    x = torch.randn((batch, cfg.input_hw, cfg.input_hw, cfg.input_ch),
                    generator=gen, device=device)
    for op, src, p, byp in walk(program, params, x, impl="reference"):
        if op.kernel in ("conv2d", "matmul"):
            yield op, src, p, byp


def conv_case(op, x, p, byp):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.common import apply_activation
    from repro_torch.kernels.conv2d.kernel import (conv2d_virtual_cuda,
                                                   conv2d_virtual_plain,
                                                   pool_ref)
    from repro_torch.kernels.conv2d.ops import norm_pool, virtual_plan
    g, dataflow, _ = virtual_plan(
        tuple(x.shape), tuple(p["w"].shape), stride=op.stride, pad=op.pad,
        pool=norm_pool(op.fuse_pool), has_bypass=byp is not None,
        tiling=op.conv_tiling, dataflow=op.dataflow)
    kw = dict(bias=p["b"] if op.fuse_bias else None,
              activation=op.fuse_activation, bypass=byp,
              bypass_first=op.bypass_first)
    x = x.contiguous()
    kern = lambda: conv2d_virtual_cuda(x, p["w"], g, dataflow=dataflow, **kw)
    plain = lambda: conv2d_virtual_plain(x, p["w"], g, **kw)
    w_lib = p["w"].permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    x_lib = x.permute(0, 3, 1, 2)            # NHWC data as channels_last
    byp_lib = None if byp is None else byp.permute(0, 3, 1, 2)

    def library():
        out = F.conv2d(x_lib, w_lib, kw["bias"], g.stride, g.pad)
        if byp_lib is not None and op.bypass_first:
            out = out + byp_lib
        out = apply_activation(out, op.fuse_activation)
        if byp_lib is not None and not op.bypass_first:
            out = out + byp_lib
        if g.pool is not None:
            out = pool_ref(out.permute(0, 2, 3, 1), g.pool)
        return out

    err = max_err(kern(), plain())
    flops = 2 * g.B * g.OH * g.OW * g.Cout * g.kh * g.kw * g.Cin
    nbytes = 4 * (x.numel() + p["w"].numel() + g.Cout
                  + g.B * g.OHo * g.OWo * g.Cout
                  + (0 if byp is None else byp.numel()))
    return "conv2d_virtual", err, kern, plain, library, flops, nbytes, (
        f"{tuple(x.shape)}*{tuple(p['w'].shape)} s{g.stride} p{g.pad} "
        f"rows={g.out_rows} kpt={g.kpt} pool={g.pool} "
        f"bypass={byp is not None} {dataflow.name}")


def matmul_case(op, x, p, byp):
    import torch
    from repro_torch.kernels.common import apply_activation
    from repro_torch.kernels.matmul.kernel import matmul_cuda, matmul_plain
    a = x.reshape(x.shape[0], -1).contiguous()
    w = p["w"]
    M, K = a.shape
    N = w.shape[1]
    block = tuple(min(v, -(-d // 128) * 128) for v, d in
                  zip(op.block, (M, K, N)))
    bias = p["b"] if op.fuse_bias else None
    kw = dict(bias=bias, activation=op.fuse_activation, bypass=byp)
    kern = lambda: matmul_cuda(a, w, dataflow=op.dataflow, block=block, **kw)
    plain = lambda: matmul_plain(a, w, **kw)

    def library():
        out = torch.addmm(bias, a, w) if bias is not None else a @ w
        return apply_activation(out, op.fuse_activation)

    err = max_err(kern(), plain())
    flops = 2 * M * N * K
    nbytes = 4 * (M * K + K * N + M * N + (0 if bias is None else N))
    return "matmul", err, kern, plain, library, flops, nbytes, (
        f"{M}x{K}x{N} block={block} {op.dataflow.name}")


def check_kernels(device, peaks):
    """Phase 3; returns the per-op rows."""
    from repro_torch.configs import CNN_REGISTRY
    rows, seen = [], set()
    for arch in ("alexnet-owt", "resnet18"):
        for op, x, p, byp in op_cases(CNN_REGISTRY[arch], SLOTS, device):
            case = conv_case if op.kernel == "conv2d" else matmul_case
            name, err, kern, plain, library, flops, nbytes, desc = case(
                op, x, p, byp)
            if desc in seen:
                continue
            seen.add(desc)
            row = {"arch": arch, "op": op.name, "kernel": name,
                   "shape": desc, "max_abs_err": err,
                   "ms": time_ms(kern), "plain_ms": time_ms(plain),
                   "library_ms": time_ms(library),
                   "flop_ms": flops / peaks[0] * 1e3,
                   "byte_ms": nbytes / peaks[1] * 1e3}
            row["bound_ms"] = max(row["flop_ms"], row["byte_ms"])
            rows.append(row)
            print(f"  {arch:11s} {op.name:7s} {name:14s} err={err:.2e} "
                  f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
                  f"lib={row['library_ms']:.4f} bound={row['bound_ms']:.4f} "
                  f"| {desc}", flush=True)
    return rows


def top2_ok(logits) -> "torch.Tensor":
    top = logits.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]) > 1e-4


def serve_main_path(device):
    """Phase 4: the port's serving entry point, on the kernels."""
    import numpy as np
    import torch
    from repro_torch.kernels.conv2d.kernel import conv2d_virtual_cuda
    from repro_torch.kernels.matmul.kernel import matmul_cuda
    from repro_torch.launch import serve
    from repro_torch.runtime import executor
    conv2d_virtual_cuda.launches = 0
    matmul_cuda.launches = 0
    res = serve.main(["--arch", "alexnet-owt", "--slots", str(SLOTS),
                      "--requests", str(REQUESTS), "--seed", str(SEED)])
    launches = {"conv2d_virtual": conv2d_virtual_cuda.launches,
                "matmul": matmul_cuda.launches}
    eng, done = res["engine"], res["done"]
    if len(done) != REQUESTS or not all(r.done for r in done):
        fail(f"served {len(done)} of {REQUESTS} requests")
    kinds = [op.kernel for op in eng.program.ops]
    want = {"conv2d_virtual": eng.n_ticks * kinds.count("conv2d"),
            "matmul": eng.n_ticks * kinds.count("matmul")}
    print(f"main path: {eng.n_ticks} ticks, launches {launches}, "
          f"want {want}")
    if launches != want:
        fail(f"launch counts {launches} != ticks x ops {want}")
    # The plain path on the card, batch by batch as the engine ran it.
    got = [r.out_tokens[0] for r in done]
    images = np.stack(res["images"])
    n_cmp = 0
    for i in range(0, REQUESTS, SLOTS):
        chunk = images[i:i + SLOTS]
        pad = np.zeros((SLOTS - len(chunk),) + chunk.shape[1:], np.float32)
        x = torch.from_numpy(np.concatenate([chunk, pad])).to(device)
        ref = executor.run(eng.program, eng.params, x, impl="reference")
        ker = executor.run(eng.program, eng.params, x, impl="cuda")
        max_err(ker, ref)
        keep = top2_ok(ref)[:len(chunk)].tolist()
        want_ids = ref.argmax(-1)[:len(chunk)].tolist()
        for k, (ok, w) in enumerate(zip(keep, want_ids)):
            if ok:
                n_cmp += 1
                if got[i + k] != w:
                    fail(f"request {i + k}: class {got[i + k]} != plain {w}")
    print(f"main path: {n_cmp}/{REQUESTS} class ids compared, all equal "
          f"to the plain path; {REQUESTS / res['seconds']:.1f} img/s "
          f"({res['seconds']:.3f} s)")
    return launches, REQUESTS / res["seconds"]


def resnet18_forward(device):
    import torch
    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.models import cnn, init_params
    from repro_torch.runtime import executor
    cfg = CNN_REGISTRY["resnet18"]
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    params = init_params(cnn.param_defs(cfg), gen, device)
    x = torch.randn((SLOTS, 224, 224, 3), generator=gen, device=device)
    program = cnn.compile_program(cfg, batch=SLOTS)
    ker = executor.run(program, params, x, impl="cuda")
    ref = executor.run(program, params, x, impl="reference")
    err = max_err(ker, ref)
    print(f"resnet18 batch {SLOTS}: logits {tuple(ker.shape)}, max |err| "
          f"{err:.3e} against the plain path")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.common import BUILD_LOGS, build_kernels

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    if name not in PEAKS:
        fail(f"no data-sheet peaks for {name!r}; bound_ms needs them")
    peaks = PEAKS[name]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"f32 peak {peaks[0] / 1e12:.0f} TFLOP/s, HBM "
          f"{peaks[1] / 1e12:.2f} TB/s (data sheet)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    secs = build_kernels()
    print(f"built kernels in {time.perf_counter() - t0:.1f} s: {secs}")
    for lib, log in BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {lib}: {line.strip()}")

    rows = check_kernels(device, peaks)
    launches, img_s = serve_main_path(device)
    resnet18_forward(device)

    kernels = []
    for kname in ("conv2d_virtual", "matmul"):
        mine = [r for r in rows if r["kernel"] == kname]
        tick = [r for r in mine if r["arch"] == "alexnet-owt"]
        flop = sum(r["flop_ms"] for r in tick)
        byte = sum(r["byte_ms"] for r in tick)
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": sum(r["ms"] for r in tick),
            "plain_ms": sum(r["plain_ms"] for r in tick),
            "bound_ms": sum(r["bound_ms"] for r in tick),
            "bound_by": "operations" if flop >= byte else "bytes",
            "library_ms": sum(r["library_ms"] for r in tick)})
    print(f"alexnet-owt serving: {img_s:.1f} img/s at {SLOTS} slots")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
