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
   to 9216 terms), and the device time of the kernel, the plain
   version, and the library yardstick (cuDNN ``F.conv2d`` or
   ``torch.addmm``, plus the same epilogue): 20 calls captured in one
   CUDA graph, so the host's launch latency is not in the reading;
4. every distinct flash-attention, decode-attention and matmul op of the
   smollm-360m (prefill, decode) Program pair at full width, 8 slots,
   max_len 512, and of the same pair with a 128-row window, on random
   operands in the executor's layouts (decode: 8 sequences with mixed
   kv_len, some of them a full, wrapped ring).  Each op is checked in
   f32 (atol = rtol = 1e-4) and in bf16 (atol = rtol = 2^-7: kernel and
   plain version both sum in f32 and round once to bf16, so they may
   land on neighbouring bf16 values, one ulp apart) and timed in bf16,
   the main path's type; the library yardsticks are
   ``F.scaled_dot_product_attention`` (GQA, with the mask) and
   ``torch.addmm`` plus the epilogue.  ``bound_ms`` is max(FLOPs / the
   operand type's peak, bytes / HBM rate) from the data sheet of the
   card named, counting each input read once, each output written once
   and only the unmasked work (causal and window pairs, live cache
   rows);
5. the main paths, each with the launch counters set to 0 just before
   it and read just after:
   a. ``repro_torch.launch.serve`` serves 20 alexnet-owt images at full
      width with 8 slots; every class must equal the plain path's on
      the card (rows whose top-2 logit gap exceeds 1e-4), and each
      counter must equal ticks x ops of that kind; then one resnet18
      batch-8 forward, kernels against plain;
   b. ``repro_torch.launch.serve --arch smollm-360m`` at full width in
      bf16 (random weights from the seed), 8 slots, max_len 512, 16
      requests with prompt lengths drawn in 32-448, 32 new tokens each;
      then the same with ``--window 128``, whose rings wrap while
      decoding.  Every request must be served with no prefill
      recomputed, and the counters must be exactly flash = prefills x
      32, decode_attention = decode ticks x 32 and matmul = (prefills +
      ticks) x 225.  The calls are recorded and replayed through the
      plain path on the card, teacher-forced with the kernel path's
      tokens: each logits row must agree within ``LOGIT_TOL``, and the
      served token must equal the plain path's wherever the plain top-2
      gap exceeds twice the row's largest logit difference (no two
      logits can swap order there);
6. a ``kernels`` JSON line: per kernel, its launches on the main paths,
   the max error over every checked op, and the times and bound summed
   over one alexnet-owt batch-8 tick (conv2d_virtual), one smollm-360m
   admission (flash_attention) or one smollm-360m decode tick
   (decode_attention, matmul);
7. the last line: ``{"ok": true, "device": {...}}``.

TF32 is switched off for cuDNN and cuBLAS, so the plain versions and
the library yardsticks compute in full f32 like the kernels.  Inputs are
not flushed from the 50 MB L2 between timed calls.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
TOL = 1e-4
BF16_TOL = 2.0 ** -7
SLOTS, REQUESTS, SEED = 8, 20, 0
LM_ARCH, LM_MAX_LEN, LM_WINDOW = "smollm-360m", 512, 128
LM_ARGS = ["--arch", LM_ARCH, "--slots", str(SLOTS), "--max-len",
           str(LM_MAX_LEN), "--requests", "16", "--prompt-len", "32-448",
           "--max-new", "32", "--seed", str(SEED)]
# Logit agreement of the served bf16 streams with the plain path: both
# round every activation to bf16, but sum in other orders, so a value
# may round to a neighbouring bf16 (2^-8 relative) at any of the ~10
# roundings per layer, and the differences compound over 32 layers into
# logits of magnitude ~4 (random weights, unit-variance head).
LOGIT_TOL = 0.25
# Peak operation rates by operand type and the HBM rate, by card name:
# NVIDIA's data sheet for the H100 SXM part at 700 W (f32 outside the
# tensor cores, bf16 dense tensor cores).  Another card has no entry
# here and the script stops rather than bound it by a wrong peak.
PEAKS = {"NVIDIA H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12,
                                   "hbm": 3.35e12}}
REPLACES = {"conv2d_virtual": "src/repro/kernels/conv2d/kernel.py:241",
            "matmul": "src/repro/kernels/matmul/kernel.py:79",
            "flash_attention": "src/repro/kernels/flash_attention/kernel.py:88",
            "decode_attention":
                "src/repro/kernels/decode_attention/kernel.py:76"}
SOURCES = {"conv2d_virtual": "src/repro_torch/kernels/csrc/conv2d.cu",
           "matmul": "src/repro_torch/kernels/csrc/matmul.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "decode_attention":
               "src/repro_torch/kernels/csrc/decode_attention.cu"}


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one ``fn()`` call: ``reps`` calls captured into one
    CUDA graph after ``warmup`` eager calls, the graph replayed five
    times between CUDA events, the median replay over ``reps``.  The
    graph keeps the host's launch latency out of the reading, so a
    kernel shorter than its Python wrapper is timed, not the wrapper."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def max_err(got, want, tol: float = TOL) -> float:
    """max |got - want|; fails unless every element is within atol = rtol
    = ``tol`` and finite."""
    import torch
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"kernel output {tuple(got.shape)} not finite or not "
             f"{tuple(want.shape)}")
    err = (got - want).abs()
    if not bool((err <= tol + tol * want.abs()).all()):
        fail(f"kernel disagrees with its plain version: max |err| "
             f"{err.max().item():.3e} (tolerance {tol:.3e})")
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
    """Phase 3; returns the per-op rows (f32)."""
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
                   "flop_ms": flops / peaks["float32"] * 1e3,
                   "byte_ms": nbytes / peaks["hbm"] * 1e3}
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


def serve_alexnet(device):
    """Phase 5a: the port's CNN serving entry point, on the kernels."""
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


# --- the smollm-360m serving path ------------------------------------------------
def lm_pairs():
    """The smollm-360m config and its (prefill, decode) pairs, plain and
    windowed, at the main path's geometry."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config(LM_ARCH)
    return cfg, {name: transformer.compile_program_pair(
        c, slots=SLOTS, max_len=LM_MAX_LEN) for name, c in (
            ("full", cfg),
            ("window", dataclasses.replace(cfg, attn_window=LM_WINDOW)))}


def _weight_shape(defs, key):
    path, _, idx = key.partition(":")
    d = defs
    for part in path.split("/"):
        d = d[part]
    return d.shape[1:] if idx else d.shape


def lm_op_descs(cfg, pairs):
    """(distinct ops by description, per (pair, program) op counts)."""
    from repro_torch.models import transformer
    defs = transformer.param_defs(cfg)
    ops, uses = {}, {}
    for pname, pair in pairs.items():
        for kind, prog, M in (("prefill", pair.prefill, LM_MAX_LEN),
                              ("decode", pair.decode, SLOTS)):
            count = Counter()
            for op in prog.ops:
                if op.kernel == "matmul":
                    K, N = _weight_shape(defs, op.param_key)
                    desc = (f"matmul {M}x{K}x{N} {op.dataflow.name} "
                            f"block={op.block} act={op.fuse_activation} "
                            f"bypass={op.fuse_bypass}")
                    ops[desc] = ("matmul", op, (M, K, N))
                elif op.kernel in ("flash_attention", "decode_attention"):
                    a = op.attn
                    cache = min(LM_MAX_LEN, a.window or LM_MAX_LEN)
                    desc = (f"{op.kernel} h={a.heads}/{a.kv_heads}x"
                            f"{a.head_dim} window={a.window} "
                            + (f"S={LM_MAX_LEN} bq={a.block_q} "
                               f"bkv={a.block_kv}" if kind == "prefill"
                               else f"cache={cache} slots={SLOTS}"))
                    ops[desc] = (op.kernel, op, (cache,))
                else:
                    continue
                count[desc] += 1
            uses[(pname, kind)] = count
    return ops, uses


def lm_matmul_case(op, shape, dtype, device, gen):
    import torch
    from repro_torch.kernels.common import apply_activation
    from repro_torch.kernels.matmul.kernel import matmul_cuda, matmul_plain
    M, K, N = shape
    a = torch.randn((M, K), generator=gen, device=device).to(dtype)
    w = (torch.randn((K, N), generator=gen, device=device)
         * K ** -0.5).to(dtype)
    byp = (torch.randn((M, N), generator=gen, device=device).to(dtype)
           if op.fuse_bypass else None)
    kw = dict(activation=op.fuse_activation, bypass=byp)
    block = tuple(min(v, -(-d // 128) * 128) for v, d in
                  zip(op.block, (M, K, N)))
    kern = lambda: matmul_cuda(a, w, dataflow=op.dataflow, block=block, **kw)
    plain = lambda: matmul_plain(a, w, **kw)

    def library():
        out = torch.addmm(byp, a, w) if byp is not None else a @ w
        return apply_activation(out, op.fuse_activation)
    by = a.element_size()
    return (kern, plain, library, 2 * M * K * N,
            by * (M * K + K * N + M * N * (2 if byp is not None else 1)))


def lm_flash_case(op, dtype, device, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)
    a, S = op.attn, LM_MAX_LEN

    def heads(H):                    # the executor's (B, S, H, D) layout
        return torch.randn((1, S, H, a.head_dim), generator=gen,
                           device=device).to(dtype).transpose(1, 2)
    q, k, v = heads(a.heads), heads(a.kv_heads), heads(a.kv_heads)
    scale = a.head_dim ** -0.5
    qi = torch.arange(S, device=device)[:, None]
    ki = torch.arange(S, device=device)[None, :]
    allowed = ki <= qi
    if a.window:
        allowed &= ki > qi - a.window
    kern = lambda: flash_attention(q, k, v, causal=a.causal, window=a.window,
                                   block_q=a.block_q, block_kv=a.block_kv,
                                   impl="cuda")
    plain = lambda: flash_attention_plain(q, k, v, scale=scale,
                                          causal=a.causal, window=a.window,
                                          kv_len=None)[0]
    mask = None if not a.window else allowed
    library = lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=mask is None, scale=scale,
        enable_gqa=True)
    by = q.element_size()
    pairs = int(allowed.sum())
    return (kern, plain, library, 4 * a.head_dim * a.heads * pairs,
            by * S * a.head_dim * (2 * a.heads + 2 * a.kv_heads)
            + 4 * a.heads * S)


def _kv_lens(cache: int):
    """Mixed live lengths for 8 sequences; the cache-length ones are full
    rings that have wrapped."""
    lens = [1, 37, cache // 4, cache // 2, cache - 1, cache, cache,
            (3 * cache) // 4]
    return lens[:SLOTS]


def lm_decode_case(op, cache, dtype, device, gen):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_plain)
    a = op.attn
    q = torch.randn((SLOTS, a.heads, a.head_dim), generator=gen,
                    device=device).to(dtype)
    # the (slots, rows, kv heads, D) cache regions, viewed (B, Hkv, S, D)
    ck, cv = (torch.randn((SLOTS, cache, a.kv_heads, a.head_dim),
                          generator=gen, device=device).to(dtype)
              for _ in range(2))
    k, v = ck.transpose(1, 2), cv.transpose(1, 2)
    lens = _kv_lens(cache)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
    scale = a.head_dim ** -0.5
    kern = lambda: decode_attention(q, k, v, kv_len=kv_len, impl="cuda")
    plain = lambda: decode_attention_plain(q, k, v, kv_len, scale=scale)
    mask = (torch.arange(cache, device=device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    library = lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, scale=scale,
        enable_gqa=True)[:, :, 0]
    by, live = q.element_size(), sum(lens)
    return (kern, plain, library, 4 * a.head_dim * a.heads * live,
            by * (2 * q.numel() + 2 * a.kv_heads * a.head_dim * live)
            + 4 * SLOTS)


def check_lm_kernels(device, peaks):
    """Phase 4; returns (rows by description, per (pair, program) op
    counts)."""
    import torch
    cfg, pairs = lm_pairs()
    ops, uses = lm_op_descs(cfg, pairs)
    rows = {}
    for i, (desc, (kernel, op, shape)) in enumerate(sorted(ops.items())):
        errs = []
        for dtype, tol in ((torch.float32, TOL), (torch.bfloat16, BF16_TOL)):
            gen = torch.Generator(device=device).manual_seed(SEED + i)
            if kernel == "matmul":
                case = lm_matmul_case(op, shape, dtype, device, gen)
            elif kernel == "flash_attention":
                case = lm_flash_case(op, dtype, device, gen)
            else:
                case = lm_decode_case(op, shape[0], dtype, device, gen)
            kern, plain, library, flops, nbytes = case
            errs.append(max_err(kern(), plain(), tol))
        name = "flash_attention" if kernel == "flash_attention" else kernel
        row = {"kernel": name, "shape": desc, "err_f32": errs[0],
               "err_bf16": errs[1], "max_abs_err": max(errs),
               "ms": time_ms(kern), "plain_ms": time_ms(plain),
               "library_ms": time_ms(library),
               "flop_ms": flops / peaks["bfloat16"] * 1e3,
               "byte_ms": nbytes / peaks["hbm"] * 1e3}
        row["bound_ms"] = max(row["flop_ms"], row["byte_ms"])
        rows[desc] = row
        print(f"  {name:16s} err f32={errs[0]:.2e} bf16={errs[1]:.2e} "
              f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
              f"lib={row['library_ms']:.4f} bound={row['bound_ms']:.4f} "
              f"| {desc}", flush=True)
        del case, kern, plain, library
    return rows, uses


def lm_sums(rows, uses, pname, kind, kernel):
    """Times and bounds of ``kernel`` summed over one run of the
    (``pname``, ``kind``) Program, each op counted once."""
    out = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                            "flop_ms", "byte_ms")}
    n = 0
    for desc, count in uses[(pname, kind)].items():
        if rows[desc]["kernel"] != kernel:
            continue
        n += count
        for k in out:
            out[k] += count * rows[desc][k]
    out["launches"] = n
    return out


class Recorder:
    """Wraps the executor's run_prefill / run_decode while the LM main
    path runs: keeps each call's inputs and the logits rows the engine
    reads, and its wall time up to a device synchronise."""

    def __init__(self):
        from repro_torch.runtime import executor
        self.ex = executor
        self.prefill, self.decode = executor.run_prefill, executor.run_decode
        self.calls = []

    def __enter__(self):
        import torch

        def run_prefill(program, params, tokens, state, slot, length, *,
                        impl="auto"):
            t0 = time.perf_counter()
            out = self.prefill(program, params, tokens, state, slot, length,
                               impl=impl)
            torch.cuda.synchronize()
            self.calls.append(("prefill", time.perf_counter() - t0,
                               (tokens.clone(), slot, length),
                               out[0, length - 1].clone()))
            return out

        def run_decode(program, params, tokens, state, mask=None, *,
                       impl="auto"):
            t0 = time.perf_counter()
            out = self.decode(program, params, tokens, state, mask,
                              impl=impl)
            torch.cuda.synchronize()
            self.calls.append(("decode", time.perf_counter() - t0,
                               (tokens.clone(), mask.clone()), out.clone()))
            return out
        self.ex.run_prefill, self.ex.run_decode = run_prefill, run_decode
        return self

    def __exit__(self, *exc):
        self.ex.run_prefill, self.ex.run_decode = self.prefill, self.decode

    def replay_plain(self, eng):
        """The recorded calls again through the plain path on a fresh
        state, teacher-forced with the kernel path's inputs; returns
        (max |logit diff|, rows compared, token ids compared)."""
        import numpy as np
        state = self.ex.init_program_state(eng.program, eng.device)
        worst, n_rows, n_ids = 0.0, 0, 0
        for kind, _, args, got in self.calls:
            if kind == "prefill":
                tokens, slot, length = args
                want = self.prefill(eng.program.prefill, eng.params, tokens,
                                    state, slot, length,
                                    impl="reference")[0, length - 1]
                pairs = [(got, want)]
            else:
                tokens, mask = args
                want = self.decode(eng.program.decode, eng.params, tokens,
                                   state, mask, impl="reference")
                pairs = [(got[i], want[i])
                         for i in mask.nonzero().flatten().tolist()]
            for g, w in pairs:
                g = g.float().cpu().numpy()
                w = w.float().cpu().numpy()
                diff = float(np.abs(g - w).max())
                worst = max(worst, diff)
                n_rows += 1
                if not np.isfinite(g).all() or diff > LOGIT_TOL:
                    fail(f"{kind}: served logits differ from the plain "
                         f"path by {diff:.3e} > {LOGIT_TOL}")
                top2 = np.sort(w)[-2:]
                if top2[1] - top2[0] > 2 * diff:
                    n_ids += 1
                    if int(np.argmax(g)) != int(np.argmax(w)):
                        fail(f"{kind}: served token {int(np.argmax(g))} != "
                             f"plain {int(np.argmax(w))} with a top-2 gap "
                             f"of {top2[1] - top2[0]:.3f}")
        return worst, n_rows, n_ids


def serve_lm(extra_args: list[str]):
    """Phase 5b: the LM serving entry point on the kernels, counters
    read around it, then the teacher-forced plain replay."""
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.matmul.kernel import matmul_cuda
    from repro_torch.launch import serve
    counters = {"flash_attention": flash_attention_cuda,
                "decode_attention": decode_attention_cuda,
                "matmul": matmul_cuda}
    for fn in counters.values():
        fn.launches = 0
    with Recorder() as rec:
        res = serve.main(LM_ARGS + extra_args)
    launches = {k: fn.launches for k, fn in counters.items()}
    eng, done = res["engine"], res["done"]
    want_n = int(LM_ARGS[LM_ARGS.index("--requests") + 1])
    max_new = int(LM_ARGS[LM_ARGS.index("--max-new") + 1])
    if len(done) != want_n or not all(
            r.done and len(r.out_tokens) == max_new for r in done):
        fail(f"served {len(done)} of {want_n} requests in full")
    if eng.n_prefill_recomputes or eng.n_prefills != want_n:
        fail(f"prefills {eng.n_prefills}, recomputes "
             f"{eng.n_prefill_recomputes}")
    mm = {kind: sum(op.kernel == "matmul" for op in prog.ops)
          for kind, prog in (("prefill", eng.program.prefill),
                             ("decode", eng.program.decode))}
    L = eng.cfg.n_layers
    want = {"flash_attention": eng.n_prefills * L,
            "decode_attention": eng.n_decode_ticks * L,
            "matmul": eng.n_prefills * mm["prefill"]
            + eng.n_decode_ticks * mm["decode"]}
    print(f"main path: {eng.n_prefills} prefills, {eng.n_decode_ticks} "
          f"decode ticks, {mm} matmul ops per Program; launches "
          f"{launches}, want {want}")
    if launches != want or mm != {"prefill": 225, "decode": 225}:
        fail(f"launch counts {launches} != {want}")
    worst, n_rows, n_ids = rec.replay_plain(eng)
    n_tok = sum(len(r.out_tokens) for r in done)
    pre = [c[1] for c in rec.calls if c[0] == "prefill"]
    dec = [c[1] for c in rec.calls if c[0] == "decode"]
    stats = {"tok_s": n_tok / res["seconds"], "seconds": res["seconds"],
             "tokens": n_tok, "prefill_ms": 1e3 * statistics.mean(pre),
             "tick_ms": 1e3 * statistics.mean(dec),
             "prefills": eng.n_prefills, "ticks": eng.n_decode_ticks}
    print(f"main path: {n_rows} logits rows within {worst:.3e} of the "
          f"plain path (tolerance {LOGIT_TOL}); {n_ids} token ids "
          f"compared, all equal; {stats['tok_s']:.1f} tok/s ({n_tok} "
          f"tokens in {res['seconds']:.3f} s); prefill "
          f"{stats['prefill_ms']:.2f} ms per admission, decode tick "
          f"{stats['tick_ms']:.2f} ms mean")
    return launches, stats


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
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; peaks "
          f"f32 {peaks['float32'] / 1e12:.0f} TFLOP/s, bf16 "
          f"{peaks['bfloat16'] / 1e12:.0f} TFLOP/s, HBM "
          f"{peaks['hbm'] / 1e12:.2f} TB/s (data sheet)")
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
    lm_rows, uses = check_lm_kernels(device, peaks)
    cnn_launches, img_s = serve_alexnet(device)
    resnet18_forward(device)
    lm_launches, lm_stats = serve_lm([])
    win_launches, win_stats = serve_lm(["--window", str(LM_WINDOW)])

    tick = {}
    for kname in ("conv2d_virtual", "matmul"):
        mine = [r for r in rows if r["kernel"] == kname
                and r["arch"] == "alexnet-owt"]
        tick[kname] = {k: sum(r[k] for r in mine) for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "flop_ms",
            "byte_ms")}
    lm = {(p, kind, k): lm_sums(lm_rows, uses, p, kind, k)
          for p in ("full", "window") for kind in ("prefill", "decode")
          for k in ("flash_attention", "decode_attention", "matmul")}
    for p, stats in (("full", lm_stats), ("window", win_stats)):
        for kind, key in (("prefill", "prefill_ms"), ("decode", "tick_ms")):
            ks = [lm[(p, kind, k)] for k in ("flash_attention",
                                             "decode_attention", "matmul")]
            print(f"smollm-360m {p} {kind}: served {stats[key]:.3f} ms "
                  f"per call against a kernel sum of "
                  f"{sum(x['ms'] for x in ks):.3f} ms (bound "
                  f"{sum(x['bound_ms'] for x in ks):.4f} ms; "
                  + ", ".join(f"{k} {x['launches']} x = {x['ms']:.3f} ms"
                              for k, x in zip(("flash", "decode", "matmul"),
                                              ks)) + ")")
    print(f"alexnet-owt tick: matmul {tick['matmul']['ms']:.4f} ms "
          f"(3 launches)")

    launches = {k: cnn_launches.get(k, 0) + lm_launches.get(k, 0)
                + win_launches.get(k, 0) for k in SOURCES}
    errs = {k: max([r["max_abs_err"] for r in rows if r["kernel"] == k]
                   + [r["max_abs_err"] for r in lm_rows.values()
                      if r["kernel"] == k]) for k in SOURCES}
    per = {"conv2d_virtual": ("alexnet-owt batch-8 tick",
                              tick["conv2d_virtual"]),
           "flash_attention": ("smollm-360m admission (prefill)",
                               lm[("full", "prefill", "flash_attention")]),
           "decode_attention": ("smollm-360m decode tick",
                                lm[("full", "decode", "decode_attention")]),
           "matmul": ("smollm-360m decode tick",
                      lm[("full", "decode", "matmul")])}
    kernels = []
    for kname in ("conv2d_virtual", "matmul", "flash_attention",
                  "decode_attention"):
        what, t = per[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": ("operations" if t["flop_ms"] >= t["byte_ms"]
                         else "bytes"),
            "library_ms": t["library_ms"]})
        print(f"kernels line: {kname} times per {what}")
        if launches[kname] == 0:
            fail(f"{kname} was never launched on the main paths")
    print(f"alexnet-owt serving: {img_s:.1f} img/s at {SLOTS} slots; "
          f"smollm-360m serving: {lm_stats['tok_s']:.1f} tok/s, window "
          f"{LM_WINDOW}: {win_stats['tok_s']:.1f} tok/s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
