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
   Programs at batch 8, and of their SNOWFLAKE paper-faithful Programs
   (every conv on materialized strips), on real activations (the plain
   forward's), through the kernel's wrapper and its plain version: max
   |err| (atol = rtol = 1e-4: f32 sums in another order over reductions
   of up to 9216 terms), and the device time of the kernel, the plain
   version, and the library yardstick (cuDNN ``F.conv2d`` on the whole
   maps or ``torch.addmm``, plus the same epilogue): 20 calls captured
   in one CUDA graph, so the host's launch latency is not in the
   reading.  A materialized conv also prints the strip copy's own time,
   the maps' bytes against the strip buffer's, and the HBM bytes
   ``core/dataflow.py::conv_strip_traffic`` models for it; its bound
   counts the strip buffer read once and only the OH rows' FLOPs.  Each
   conv row ends with ``conv_plan``'s launch (pixel tile, splits and
   slices of K, CTAs, a fused pool's pooled tile and conv region); the
   kernels' ptxas lines (registers, spills) print after the build.  Then
   every conv of the alexnet-owt zero-copy and paper-faithful Programs
   again in bf16 (maps, weights, bias, bypass), both kernels against
   their plain versions at atol = rtol = 2^-7, untimed;
4. every distinct flash-attention, decode-attention and matmul op of the
   smollm-360m (prefill, decode) Program pair at full width, 8 slots,
   max_len 512, of the same pair with a 128-row window, and of the
   zamba2-7b pair (its shared block's attention at head dim 112: 32 q
   over 32 kv heads, S = 512, window 4096, causal), on random
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
   rows).  Each decode row prints ``decode_plan``'s split (splits x
   split rows, tile rows, CTAs) and is also checked over a float8 e4m3
   cache (the config's ``kv_dtype="float8"``) under bf16 q (2^-7) and
   f32 q (1e-4).  The paged decode op runs at the same
   width and lengths over (257, 16, 5, 64) pools through a table of
   shuffled page ids, two pairs of sequences sharing pages: f32 (1e-4),
   bf16 (2^-7) and int8 pools with bf16 q (2^-7), each with its plan;
   its bound counts each distinct live page row once, and beside it are
   timed the contiguous kernel at the same lengths and, as the library
   yardstick, SDPA over the already-gathered view.  The same operands at
   head dim 112 in bf16 and int8 pools (bf16 q, 2^-7) are checked, not
   timed.  The flash-attention backward runs at the training shape (batch
   8, 15 q / 5 kv heads of 64, 512 rows): causal, window 128 and a
   kv_len = 450 mask, f32 (1e-4) and bf16 (one bf16 ulp plus the f32
   rounding bound of the plain version's sums, ``bwd_slack``), on the
   forward kernel's out and lse, against its plain version; the causal
   case also on simt in bf16 (operands off a 16-byte boundary) at one
   bf16 ulp; the trainable wrapper
   (forward and backward kernels under autograd) against ``flash_ref``'s
   autograd in f32 (1e-4); then timed in bf16, causal, beside the forward
   kernel at the same shape (with its plain version, SDPA's forward and
   its bound) and SDPA's backward (forward + backward minus forward: no
   single PyTorch call computes the backward alone).  Its
   bound counts 5 products of 2 D FLOP per unmasked (q, k) pair and the
   bytes of q, k, v, out, dO, lse, dq, dk and dv.  The recurrent kernels
   against their plain versions (the sequential f32 recurrence), f32 at
   1e-4 and bf16 at 2^-7 (their f32 final states at 1e-4): mamba2_scan at
   zamba2-7b's admission (1, 512, 112, 64), N = 64, with and without h0,
   its decode tick (8, 1, 112, 64), an L of 300 (not a multiple of the
   kernels' 64-step chunk) and L = 2048 (32 chunks), on strided column
   slices as the model hands them; wkv6 at rwkv6-7b's admission (1, 512,
   64, 64), with and without s0, a short L, L = 2048 and head dim 48.
   Each case prints the plan it ran on (``ssd_plan``: step or chunked
   path, chunks, CTAs, kernels; ``wkv_plan``: chunks, CTAs, rows a
   thread).  The served shapes, L = 2048 and D = 48 are timed in bf16,
   per launch; their bound counts 5 N P (scan) or 5 D^2 (wkv) f32 FLOP
   per step and head and each operand moved once, and beside it the
   chunk-form bound: the chunked scan's products at the TF32 tensor-core
   rate (3xTF32 issues an f32 product three times, one with a bf16 side
   twice), the chunked wkv's work at the f32 FMA rate.  No PyTorch call
   computes either, so neither has a library yardstick;
   Each matmul row names the path ``matmul_plan`` gives it (skinny at
   M <= 64, wgmma for bf16 above, simt for the f32 checks at M = 512),
   and the bf16 matmul rows are summed per smollm-360m and zamba2-7b
   admission and decode tick, the f32 ones per alexnet-owt tick, with
   their launches, ``library_ms`` and ``bound_ms``.  Each flash row must
   run f32 on simt and bf16 on mma (``flash_plan``), and the bf16 flash
   times are summed per smollm-360m and zamba2-7b admission, the forward
   and the backward per training step, likewise;
5. the main paths, each with the launch counters set to 0 just before
   it and read just after.  The matmul wrapper's per-path counters must
   show every decode tick (M = 8 slots) and every CNN FC layer on the
   skinny path, every admission and chunk (M = 512 rows a prompt) on
   wgmma, and no served call on simt; the flash wrappers' must show
   every flash launch of 5b-5e, 5g and the bf16 training steps of 5f,
   forward and backward, on mma, and the f32 smoke step's on simt:
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
   c. the paged plan (``--paged --shared-prefix 256``, bf16, page 16):
      16 prompts of the shared 256-token prefix and a 32-256-token tail
      from the seed; admission shares the prefix pages, and the rings
      that pass 512 rows wrap onto shared pages, which fork.  Requires
      ``n_shared_pages > 0`` and ``n_cow_forks > 0``;
   d. int8 pages (``kv_quant="int8"``) under a 122-page pool, with tails
      of 224-256 tokens, so admission finds the pool exhausted and
      requeues at the head (``n_requeued > 0``) while every request is
      served;
   e. chunked prefill over the paged plan (``--chunk-size 128`` and a
      448-token prompt injected two ticks in): no tick starves a live
      slot and every prefill completes within ceil(length / 128) ticks of
      its slot assignment.
   In 5c-5e the counters must be exactly paged decode = ticks x 32,
   contiguous decode = 0, flash = (prefill + chunk calls) x 32, matmul =
   (prefill + chunk calls + ticks) x 225, and the teacher-forced plain
   replay (page-table syncs and COW copies replayed in order) holds the
   same logit and token rules as 5b; no serving path launches the
   backward kernel;
   f. ``repro_torch.launch.train --smoke`` takes one step of the smoke
      config as it is (head dim 16, f32, batch 2 x 64): one flash
      forward and one backward launch per layer, a finite loss, and the
      same step's loss and gradients through the kernels within 1e-4 of
      the plain path; then ``repro_torch.launch.train`` trains
      full-width smollm-360m in bf16
      (batch 8, seq 512, SyntheticLM seed 0, AdamW with the CLI's cosine
      schedule) for one warm-up and five timed steps into a temporary
      checkpoint directory: per step exactly 64 flash forward launches
      (32 layers, each recomputed under remat) and 32 backward ones, no
      matmul or decode launch, every loss finite; the step-0 params and
      batch through the plain path on the card (loss within 1e-2
      relative, global gradient norm within 2%, each leaf's largest
      gradient difference within 10% of that leaf's largest gradient); a
      fresh trainer resumed from the last checkpoint at the saved step
      with params and optimizer state equal bit for bit; tokens/s, step ms, the flash kernels' share of
      the step and the peak memory allocated are printed;
   g. ``repro_torch.launch.serve --arch zamba2-7b`` at full width and
      depth in bf16 (81 mamba layers, d_model 3584, 112 SSM heads of 64,
      N = 64; 14 applications of the shared block, 32 heads of 112), 8
      slots, max_len 512, 8 prompts of 32-448 tokens, 32 new tokens each;
   h. the same with ``--arch rwkv6-7b`` (32 layers, d_model 4096, 64
      heads of 64).
   i. ``serve_cnn`` serves the same 20 alexnet-owt images off the
      SNOWFLAKE paper-faithful Program at batch 8 (``compile_program(...,
      hw=SNOWFLAKE, paper_faithful=True)`` handed to ``ServingEngine``):
      exactly ticks x 5 ``conv2d_strips`` launches, no ``conv2d_virtual``
      launch and ticks x 3 matmul launches; classes equal the plain
      path's as in 5a; img/s beside 5a's; then one resnet18 SNOWFLAKE
      paper-faithful batch-8 forward, kernels against plain, with exactly
      20 strip launches.
   In 5g and 5h the counters must be exactly the Program's kernel ops per
   call (``PAIR_OPS``: zamba2-7b 81 mamba2_scan and 99 matmul per
   admission and per tick, 14 flash per admission, 14 decode per tick;
   rwkv6-7b 32 wkv6 per admission, none per tick -- its decode step is
   plain torch, as in the reference -- and 1 matmul per call) times the
   calls, and the teacher-forced plain replay holds each logits row
   within max(0.25, twice the largest difference between two plain
   replays that differ only in the recurrence's summation order: the
   chunked form and the sequential f32 oracle), the mean |logit diff|
   over the rows within a fixed limit (0.28 zamba2-7b, 0.08 rwkv6-7b:
   twice the two plain replays' mean on an H100) and the tokens as in
   5b; then every admission before the first decode tick and that tick
   again, op by op: each matmul, attention and recurrent-block op
   through the kernel path and through the plain path (the recurrence as
   its sequential f32 oracle) on the plain path's input, the outputs
   held at the bf16 rule (2^-7; a recurrent block's output, which feeds
   its kernel's y through a gated norm and a wide projection, at 2^-7 of
   its largest magnitude) and the recurrent states each block writes at
   1e-4; the weights' parameter count, the persistent state
   by kind and the peak memory are printed;
6. a ``kernels`` JSON line: per kernel, its launches on the main paths,
   the max error over every checked op, and the times and bound summed
   over one alexnet-owt batch-8 tick (conv2d_virtual), one SNOWFLAKE
   paper-faithful alexnet-owt batch-8 tick (conv2d_strips), one smollm-360m
   admission (flash_attention), one smollm-360m decode tick
   (decode_attention, paged_decode_attention, matmul), one smollm-360m
   training step (flash_attention_bwd), one zamba2-7b admission
   (mamba2_scan) or one rwkv6-7b admission (wkv6);
7. the last line: ``{"ok": true, "device": {...}}``.

TF32 is switched off for cuDNN and cuBLAS, so the plain versions and
the library yardsticks compute in full f32 like the kernels.  Inputs are
not flushed from the 50 MB L2 between timed calls.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
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
# The recurrent families' serving phases (5g zamba2-7b, 5h rwkv6-7b): full
# width and depth, bf16, 8 slots, max_len 512, 8 prompts of 32-448 tokens,
# 32 new tokens each.  Their replay bound is the larger of smollm's 0.25
# and twice the largest difference between two plain replays of the same
# calls that differ only in the recurrence's summation order (its chunked
# form against its sequential f32 oracle, ``FAMILY_FLOOR``).  Random-weight
# zamba2-7b (95 blocks) and rwkv6-7b (32) amplify one-ulp differences with
# depth: two plain replays of the same calls differ by up to 1.2 and 0.3
# in logits of magnitude ~5 (this script, on an H100 80GB HBM3).  No fixed
# bound on the largest difference separates that from a fault's O(1)
# error, so that floor is measured on the same calls.  Two checks do not
# move with the run: the mean |logit diff| over the rows must stay within
# ``FAMILY_MEAN_TOL``, twice the mean between the two plain replays
# (0.1419 and 0.0387 on that card; the served paths read 0.1929 and
# 0.0395), and every op of the served Program is held to its plain
# version on the same input (``check_family_ops``).
FAMILY_ARGS = ["--slots", str(SLOTS), "--max-len", str(LM_MAX_LEN),
               "--requests", "8", "--prompt-len", "32-448", "--max-new",
               "32", "--seed", str(SEED)]
FAMILY_FLOOR = {"zamba2-7b": ("zamba2", "mamba2_scan"),
                "rwkv6-7b": ("rwkv", "wkv6")}
FAMILY_MEAN_TOL = {"zamba2-7b": 0.28, "rwkv6-7b": 0.08}
# Kernel-launching ops per (prefill, decode) Program of each served pair,
# read off the Program listings; the exact launch counts multiply them.
# rwkv6's decode step is plain torch (no wkv6 launch), as in the reference.
PAIR_OPS = {
    LM_ARCH: ({"matmul": 225, "flash_attention": 32},
              {"matmul": 225, "decode_attention": 32}),
    "zamba2-7b": ({"matmul": 99, "flash_attention": 14, "ssm_scan": 81},
                  {"matmul": 99, "decode_attention": 14, "ssm_scan": 81}),
    "rwkv6-7b": ({"matmul": 1, "wkv": 32}, {"matmul": 1, "wkv": 32})}
KERNEL_OPS = ("matmul", "flash_attention", "decode_attention", "ssm_scan",
              "wkv")
# Peak operation rates by operand type and the HBM rate, by card name:
# NVIDIA's data sheet for the H100 SXM part at 700 W (f32 outside the
# tensor cores, bf16 dense tensor cores).  Another card has no entry
# here and the script stops rather than bound it by a wrong peak.
PEAKS = {"NVIDIA H100 80GB HBM3": {"float32": 67e12, "bfloat16": 989e12,
                                   "tfloat32": 495e12, "hbm": 3.35e12}}
REPLACES = {"conv2d_virtual": "src/repro/kernels/conv2d/kernel.py:241",
            "conv2d_strips": "src/repro/kernels/conv2d/kernel.py:111",
            "matmul": "src/repro/kernels/matmul/kernel.py:79",
            "flash_attention": "src/repro/kernels/flash_attention/kernel.py:88",
            "flash_attention_bwd":
                "src/repro/kernels/flash_attention/bwd_kernel.py:134",
            "decode_attention":
                "src/repro/kernels/decode_attention/kernel.py:76",
            "paged_decode_attention":
                "src/repro/kernels/decode_attention/kernel.py:175",
            "mamba2_scan": "src/repro/kernels/mamba2/kernel.py:78",
            "wkv6": "src/repro/kernels/rwkv6/kernel.py:58"}
SOURCES = {"conv2d_virtual": "src/repro_torch/kernels/csrc/conv2d.cu",
           "conv2d_strips": "src/repro_torch/kernels/csrc/conv2d_strips.cu",
           "matmul": "src/repro_torch/kernels/csrc/matmul.cu",
           "flash_attention":
               "src/repro_torch/kernels/csrc/flash_attention.cu",
           "flash_attention_bwd":
               "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
           "decode_attention":
               "src/repro_torch/kernels/csrc/decode_attention.cu",
           "paged_decode_attention":
               "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
           "mamba2_scan": "src/repro_torch/kernels/csrc/mamba2_scan.cu",
           "wkv6": "src/repro_torch/kernels/csrc/wkv6.cu"}
# The paged serving phases (5c, 5e): the serve CLI's flags after LM_ARGS
# (a later --prompt-len wins).  5d has no CLI flag for the pool size, so
# it calls serve_lm with these arguments; its tails and pool are the
# seed's draw checked to exhaust the pool at admission without running
# it dry mid-decode (admission reserves no decode pages, as in the
# reference).
PAGE_SIZE, N_PAGES, PREFIX = 16, 257, 256
PAGED_RUNS = {
    "5c paged": ["--paged", "--shared-prefix", str(PREFIX),
                 "--prompt-len", "32-256"],
    "5e chunked": ["--paged", "--chunk-size", "128", "--shared-prefix",
                   str(PREFIX), "--long-prompt", "448", "--prompt-len",
                   "32-256"]}
PAGED_5D = dict(paged=True, shared_prefix=PREFIX, prompt_len=(224, 256),
                kv_quant="int8", page_pool=122)
# The training path (phase 5f): full-width smollm-360m in bf16, batch 8,
# seq 512, one warm-up step and five timed ones.  The backward kernel is
# checked at the same attention shape (B, 15 q / 5 kv heads of 64, 512),
# causal, windowed and kv_len-masked; the autograd comparison at batch 2.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 6
# Step-0 agreement of the kernel path with the plain path on the card,
# both bf16: attention outputs and gradients are each rounded once to
# bf16 on both sides but summed in other orders, so they differ by about
# one bf16 ulp per layer, which the loss averages and the global norm
# sums over 360M gradients.
LOSS_RTOL, GNORM_RTOL = 1e-2, 0.02
# Each leaf's largest gradient difference over that leaf's largest
# gradient: sound runs read 2.9% at most (wk; H100 80GB HBM3), while a fault
# confined to one leaf's gradient (a mis-strided dq) moves it to ~100%.
LEAF_RTOL = 0.10
# The backward's bf16 check: one ulp of the plain result plus, for the
# sums that cancel, the f32 rounding bound of the plain computation: the
# unit roundoff 2^-24 times its longest chain of sums (Skv keys after D
# products), times each element's sum of absolute terms.  Both sides sum
# the same f32 terms (the mma path splits P and dS into bf16 parts that
# sum to them exactly) and round once to bf16, but in another order;
# where a sum cancels, two orders differ by more than an ulp of the
# result (the plain version against itself with 64-key chunks does, on
# the card).
def bwd_slack(Skv: int, D: int) -> float:
    return (Skv + D) * 2.0 ** -24


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def reset_matmul_paths() -> None:
    """Set the matmul wrapper's per-path launch counts to 0."""
    from repro_torch.kernels.matmul.kernel import matmul_cuda
    for path in matmul_cuda.path_launches:
        matmul_cuda.path_launches[path] = 0


def check_matmul_paths(label: str, skinny: int, wgmma: int) -> None:
    """The matmul launches since the last reset went exactly ``skinny``
    times through the skinny path, ``wgmma`` times through wgmma, and
    never through simt."""
    from repro_torch.kernels.matmul.kernel import matmul_cuda
    got = dict(matmul_cuda.path_launches)
    want = {"skinny": skinny, "wgmma": wgmma, "simt": 0}
    print(f"{label}: matmul paths {got}, want {want}")
    if got != want:
        fail(f"{label}: matmul paths {got} != {want}")


def reset_flash_paths() -> None:
    """Set the flash wrappers' per-path launch counts to 0."""
    for fn in flash_wrappers():
        for path in fn.path_launches:
            fn.path_launches[path] = 0


def flash_wrappers():
    from repro_torch.kernels.flash_attention.bwd_kernel import (
        flash_attention_bwd_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    return flash_attention_cuda, flash_attention_bwd_cuda


def check_flash_paths(label: str, fwd: int, bwd: int,
                      path: str = "mma") -> None:
    """The flash launches since the last reset went ``fwd`` (forward) and
    ``bwd`` (backward) times through ``path`` and never through the
    other one."""
    got = [dict(fn.path_launches) for fn in flash_wrappers()]
    want = [{"mma": 0, "simt": 0, path: n} for n in (fwd, bwd)]
    print(f"{label}: flash paths forward {got[0]}, backward {got[1]}; "
          f"want {want[0]}, {want[1]}")
    if got != want:
        fail(f"{label}: flash paths {got} != {want}")


def kernel_name(line: str) -> str:
    """``name<template args>`` of the kernel a ptxas "Compiling entry
    function '<mangled>'" line names: the mangled name's ``<len><name>``
    ending in ``_kernel`` and its template arguments as mangled."""
    m = re.search(r"(\w*?_kernel)(I\w*?E)?E", line)
    if not m:
        return "?"
    head = m.group(1)
    for i in range(len(head) - 1, 0, -1):
        if head[:i].endswith(str(len(head) - i)) and not head[i].isdigit():
            return f"{head[i:]}<{(m.group(2) or 'I E')[1:-1]}>"
    return head


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


def bf16_ulp(want):
    """The spacing of bf16 at |want| (at least that of the smallest
    normal), elementwise."""
    import torch
    tiny = torch.finfo(torch.bfloat16).tiny
    _, e = torch.frexp(want.float().abs().clamp_min(tiny))
    return torch.ldexp(torch.ones_like(want.float()), e - 8)


def past_ulp(got, want, slack):
    """(elements of ``got`` past one bf16 ulp of ``want``, the largest
    excess past that ulp over ``slack``, elementwise): how much of the
    f32 part of ``max_err_ulp``'s tolerance the elements use."""
    import torch
    err = (got.float() - want.float()).abs()
    over = err - bf16_ulp(want)
    excess = torch.where(over > 0, over / slack, torch.zeros_like(over))
    return int((over > 0).sum()), excess.max().item()


def unaligned(t):
    """``t`` (a (B, H, S, D) view of a (B, S, H, D) buffer) copied into a
    buffer that starts 2 bytes past a 16-byte boundary: the same values
    and layout, which the flash kernels' mma path cannot load in 16-byte
    vectors, so they run on simt."""
    import torch
    B, H, S, D = t.shape
    buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(B, S, H, D).transpose(1, 2)
    view.copy_(t)
    return view


def max_err_ulp(got, want, slack=None) -> tuple[float, float]:
    """(max |got - want|, the largest |got - want| over its tolerance) of
    two bf16 tensors; fails unless every element
    of ``got`` is finite and within one bf16 ulp of ``want`` (the spacing
    of bf16 at |want|, at least that of the smallest normal), plus
    ``slack`` (elementwise) where given.  Two f32 sums of the same terms
    differ by at most the f32 rounding error of the terms' absolute sum,
    and once rounded to bf16 by one ulp more: ``slack`` is that f32 bound
    where the rounding error can exceed an ulp (sums that cancel)."""
    import torch
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"kernel output {tuple(got.shape)} not finite or not "
             f"{tuple(want.shape)}")
    tol = bf16_ulp(want) + (0.0 if slack is None else slack)
    err = (got - want).abs()
    worst = (err / tol).max().item()
    if not worst <= 1.0:
        fail(f"kernel disagrees with its plain version by {worst:.2f} times "
             f"its tolerance (max |err| {err.max().item():.3e}; tolerance "
             f"one bf16 ulp{'' if slack is None else ' + the f32 bound'})")
    return err.max().item(), worst


def op_cases(cfg, batch, device, hw=None, paper_faithful=False):
    """Walk the Program (compiled for ``hw``, the default TPU_V5E when
    None) on the plain path; yield each conv / matmul op with the
    operands the executor hands it."""
    import torch
    from repro_torch.core import TPU_V5E
    from repro_torch.models import cnn, init_params
    from repro_torch.runtime.executor import walk
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_params(cnn.param_defs(cfg), gen, device)
    program = cnn.compile_program(cfg, batch=batch, hw=hw or TPU_V5E,
                                  paper_faithful=paper_faithful)
    x = torch.randn((batch, cfg.input_hw, cfg.input_hw, cfg.input_ch),
                    generator=gen, device=device)
    for op, src, p, byp in walk(program, params, x, impl="reference"):
        if op.kernel in ("conv2d", "matmul"):
            yield op, src, p, byp


def cudnn_conv(op, x, w, bias, byp, stride: int, pad: int, pool):
    """The library yardstick of a conv kernel: cuDNN ``F.conv2d`` on the
    whole NHWC maps (read as channels_last) with the same epilogue, then
    ``pool`` when the kernel fuses one."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.common import apply_activation
    from repro_torch.kernels.conv2d.kernel import pool_ref
    w_lib = w.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    x_lib = x.permute(0, 3, 1, 2)            # NHWC data as channels_last
    byp_lib = None if byp is None else byp.permute(0, 3, 1, 2)

    def library():
        out = F.conv2d(x_lib, w_lib, bias, stride, pad)
        if byp_lib is not None and op.bypass_first:
            out = out + byp_lib
        out = apply_activation(out, op.fuse_activation)
        if byp_lib is not None and not op.bypass_first:
            out = out + byp_lib
        if pool is not None:
            out = pool_ref(out.permute(0, 2, 3, 1), pool)
        return out
    return library


def conv_plan_text(g, *operands) -> str:
    """``conv_plan``'s launch of geometry ``g`` on these operands: pixel
    tile, splits, CTAs and, with a fused pool, the pooled tile."""
    from repro_torch.kernels.conv2d.kernel import conv_plan
    plan = conv_plan(g, aligned=all(t.data_ptr() % 16 == 0
                                    for t in operands))
    pool = (f" pooled {plan.tile_r}x{plan.tile_c} (conv {plan.conv_r}x"
            f"{plan.conv_c})" if plan.tile_r else "")
    return (f"plan: {plan.bm}-pixel tiles, {plan.splits} splits of "
            f"{plan.kps}/{plan.k_slices} slices, {plan.ctas} CTAs{pool}")


def conv_case(op, x, p, byp):
    from repro_torch.kernels.conv2d.kernel import (conv2d_virtual_cuda,
                                                   conv2d_virtual_plain)
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
    library = cudnn_conv(op, x, p["w"], kw["bias"], byp, g.stride, g.pad,
                         g.pool)
    err = max_err(kern(), plain())
    flops = 2 * g.B * g.OH * g.OW * g.Cout * g.kh * g.kw * g.Cin
    nbytes = 4 * (x.numel() + p["w"].numel() + g.Cout
                  + g.B * g.OHo * g.OWo * g.Cout
                  + (0 if byp is None else byp.numel()))
    return "conv2d_virtual", err, kern, plain, library, flops, nbytes, (
        f"{tuple(x.shape)}*{tuple(p['w'].shape)} s{g.stride} p{g.pad} "
        f"rows={g.out_rows} kpt={g.kpt} pool={g.pool} "
        f"bypass={byp is not None} {dataflow.name}; "
        f"{conv_plan_text(g, x, p['w'])}")


def strips_case(op, x, p, byp):
    """A materialized conv: the strip copy, then the strips kernel against
    its plain version on the same strips; the library yardstick is cuDNN
    on the whole maps (no pool: a requested one runs after the kernel as
    its own op).  Returns conv_case's tuple plus the copy's thunk and the
    byte counts it prints."""
    from repro_torch.core.dataflow import Dataflow, conv_strip_traffic
    from repro_torch.kernels.conv2d.kernel import (conv2d_strips_cuda,
                                                   conv2d_strips_plain,
                                                   materialize_strips,
                                                   strip_bypass)
    from repro_torch.kernels.conv2d.ops import strips_plan
    g, dataflow = strips_plan(tuple(x.shape), tuple(p["w"].shape),
                              stride=op.stride, pad=op.pad,
                              tiling=op.conv_tiling, dataflow=op.dataflow)
    x = x.contiguous()
    strips = materialize_strips(x, g)
    sbyp = None if byp is None else strip_bypass(byp, g)
    kw = dict(bias=p["b"] if op.fuse_bias else None,
              activation=op.fuse_activation, bypass=sbyp,
              bypass_first=op.bypass_first)
    kern = lambda: conv2d_strips_cuda(strips, p["w"], g, dataflow=dataflow,
                                      **kw)
    plain = lambda: conv2d_strips_plain(strips, p["w"], g, **kw)
    copy = lambda: materialize_strips(x, g)
    library = cudnn_conv(op, x, p["w"], kw["bias"], byp, g.stride, g.pad,
                         None)
    err = max_err(kern(), plain())
    flops = 2 * g.B * g.OH * g.OW * g.Cout * g.kh * g.kw * g.Cin
    out_el = g.B * g.OH * g.OW * g.Cout
    nbytes = 4 * (strips.numel() + p["w"].numel() + g.Cout + out_el
                  + (0 if byp is None else out_el))
    kloop, mloop = conv_strip_traffic(
        4 * x.numel(), 4 * p["w"].numel(), 4 * out_el, n_map_tiles=g.NS,
        n_kernel_tiles=g.Cout // g.kpt,
        overlap_frac=op.conv_tiling.overlap_frac,
        strip_storage="materialized")
    traffic = {"maps_bytes": 4 * x.numel(),
               "strip_bytes": 4 * strips.numel(),
               "modeled_bytes": (mloop if dataflow is Dataflow.WEIGHTS_RESIDENT
                                 else kloop)}
    return "conv2d_strips", err, kern, plain, library, flops, nbytes, (
        f"{tuple(x.shape)}*{tuple(p['w'].shape)} s{g.stride} p{g.pad} "
        f"rows={g.out_rows} kpt={g.kpt} strips={tuple(strips.shape)} "
        f"bypass={byp is not None} {dataflow.name}; "
        f"{conv_plan_text(g, strips, p['w'])}"), copy, traffic


def matmul_case(op, x, p, byp):
    import torch
    from repro_torch.kernels.common import apply_activation
    from repro_torch.kernels.matmul.kernel import (matmul_cuda,
                                                   matmul_plain, matmul_plan)
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
    path = matmul_plan(M, K, N, a.dtype).path
    return "matmul", err, kern, plain, library, flops, nbytes, (
        f"{M}x{K}x{N} block={block} {op.dataflow.name} path={path}")


# Phase 3's Programs: (label, arch, hardware model name, paper_faithful).
# "@snowflake" labels the SNOWFLAKE paper-faithful Program, every conv of
# which runs on materialized strips.
PHASE3_PROGRAMS = (("alexnet-owt", "alexnet-owt", None, False),
                   ("resnet18", "resnet18", None, False),
                   ("alexnet-owt@snowflake", "alexnet-owt", "SNOWFLAKE",
                    True),
                   ("resnet18@snowflake", "resnet18", "SNOWFLAKE", True))


def check_kernels(device, peaks):
    """Phase 3; returns the per-op rows (f32).  ``uses`` counts the ops of
    the row's Program that share its shape (timed once)."""
    from repro_torch import core
    from repro_torch.configs import CNN_REGISTRY
    rows, seen = [], {}
    for label, arch, hw, faithful in PHASE3_PROGRAMS:
        for op, x, p, byp in op_cases(
                CNN_REGISTRY[arch], SLOTS, device,
                hw=getattr(core, hw) if hw else None,
                paper_faithful=faithful):
            extra = None
            if op.kernel != "conv2d":
                case = matmul_case(op, x, p, byp)
            elif op.strip_storage == "materialized":
                *case, copy, traffic = strips_case(op, x, p, byp)
                extra = (copy, traffic)
            else:
                case = conv_case(op, x, p, byp)
            name, err, kern, plain, library, flops, nbytes, desc = case
            if (label, desc) in seen:
                seen[(label, desc)]["uses"] += 1
                continue
            row = {"arch": label, "op": op.name, "kernel": name,
                   "shape": desc, "max_abs_err": err, "uses": 1,
                   "ms": time_ms(kern), "plain_ms": time_ms(plain),
                   "library_ms": time_ms(library),
                   "flop_ms": flops / peaks["float32"] * 1e3,
                   "byte_ms": nbytes / peaks["hbm"] * 1e3}
            row["bound_ms"] = max(row["flop_ms"], row["byte_ms"])
            seen[(label, desc)] = row
            rows.append(row)
            more = ""
            if extra is not None:
                copy, traffic = extra
                row.update(traffic, copy_ms=time_ms(copy))
                more = (f" copy={row['copy_ms']:.4f} maps="
                        f"{traffic['maps_bytes'] / 1e6:.3f}MB strips="
                        f"{traffic['strip_bytes'] / 1e6:.3f}MB modeled="
                        f"{traffic['modeled_bytes'] / 1e6:.3f}MB")
            print(f"  {label:21s} {op.name:7s} {name:14s} err={err:.2e} "
                  f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
                  f"lib={row['library_ms']:.4f} bound={row['bound_ms']:.4f}"
                  f"{more} | {desc}", flush=True)
    return rows


def check_bf16_convs(device):
    """Phase 3's bf16 check: every conv of the alexnet-owt zero-copy and
    SNOWFLAKE paper-faithful Programs again with its maps, weights, bias
    and bypass in bf16, through the kernel (exact bf16 products, f32 sums,
    one rounding) against its plain version (f32 sums, one rounding), at
    atol = rtol = 2^-7.  Not timed.  Returns rows of (kernel, arch,
    max_abs_err)."""
    import torch
    from repro_torch.core import SNOWFLAKE
    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.kernels.conv2d.kernel import (
        conv2d_strips_cuda, conv2d_strips_plain, conv2d_virtual_cuda,
        conv2d_virtual_plain, materialize_strips, strip_bypass)
    from repro_torch.kernels.conv2d.ops import (norm_pool, strips_plan,
                                                virtual_plan)
    bf = torch.bfloat16
    rows = []
    for label, hw, faithful in (("alexnet-owt", None, False),
                                ("alexnet-owt@snowflake", SNOWFLAKE, True)):
        for op, x, p, byp in op_cases(CNN_REGISTRY["alexnet-owt"], SLOTS,
                                      device, hw=hw,
                                      paper_faithful=faithful):
            if op.kernel != "conv2d":
                continue
            xb, w = x.contiguous().to(bf), p["w"].to(bf)
            yb = None if byp is None else byp.to(bf)
            kw = dict(bias=p["b"].to(bf) if op.fuse_bias else None,
                      activation=op.fuse_activation,
                      bypass_first=op.bypass_first)
            if op.strip_storage == "materialized":
                g, dataflow = strips_plan(
                    tuple(x.shape), tuple(w.shape), stride=op.stride,
                    pad=op.pad, tiling=op.conv_tiling, dataflow=op.dataflow)
                strips = materialize_strips(xb, g)
                sbyp = None if yb is None else strip_bypass(yb, g)
                name = "conv2d_strips"
                got = conv2d_strips_cuda(strips, w, g, dataflow=dataflow,
                                         bypass=sbyp, **kw)
                want = conv2d_strips_plain(strips, w, g, bypass=sbyp, **kw)
            else:
                g, dataflow, _ = virtual_plan(
                    tuple(x.shape), tuple(w.shape), stride=op.stride,
                    pad=op.pad, pool=norm_pool(op.fuse_pool),
                    has_bypass=yb is not None, tiling=op.conv_tiling,
                    dataflow=op.dataflow)
                name = "conv2d_virtual"
                got = conv2d_virtual_cuda(xb, w, g, dataflow=dataflow,
                                          bypass=yb, **kw)
                want = conv2d_virtual_plain(xb, w, g, bypass=yb, **kw)
            if got.dtype != bf:
                fail(f"{name} {op.name} bf16 wrote {got.dtype}")
            err = max_err(got, want, BF16_TOL)
            rows.append({"kernel": name, "arch": f"{label} bf16",
                         "op": op.name, "max_abs_err": err})
            print(f"  {label:21s} {op.name:7s} {name:14s} bf16 err={err:.2e}"
                  f" (max |out| {want.float().abs().max().item():.1f})",
                  flush=True)
    return rows


def top2_ok(logits) -> "torch.Tensor":
    top = logits.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]) > 1e-4


def check_classes(res, device, label: str) -> int:
    """Every served class equals the plain path's on the card, batch by
    batch as the engine ran it, where the plain top-2 gap exceeds 1e-4;
    the kernel path's logits are held to the plain path's at 1e-4.
    Returns how many classes were compared."""
    import numpy as np
    import torch
    from repro_torch.runtime import executor
    eng, done = res["engine"], res["done"]
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
                    fail(f"{label} request {i + k}: class {got[i + k]} != "
                         f"plain {w}")
    return n_cmp


def serve_alexnet(device):
    """Phase 5a: the port's CNN serving entry point, on the kernels."""
    from repro_torch.kernels.conv2d.kernel import conv2d_virtual_cuda
    from repro_torch.kernels.matmul.kernel import matmul_cuda
    from repro_torch.launch import serve
    conv2d_virtual_cuda.launches = 0
    matmul_cuda.launches = 0
    reset_matmul_paths()
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
    check_matmul_paths("main path", want["matmul"], 0)
    n_cmp = check_classes(res, device, "5a")
    print(f"main path: {n_cmp}/{REQUESTS} class ids compared, all equal "
          f"to the plain path; {REQUESTS / res['seconds']:.1f} img/s "
          f"({res['seconds']:.3f} s)")
    return launches, REQUESTS / res["seconds"]


def serve_paper_faithful(device, virtual_img_s: float):
    """Phase 5i: the same 20 alexnet-owt images served off the SNOWFLAKE
    paper-faithful Program through ``serve_cnn`` and ``ServingEngine``,
    counters set to 0 just before and read just after: exactly ticks x 5
    strip launches, no zero-copy launch, ticks x 3 matmul launches.
    Returns (launches, img/s, served ms per tick)."""
    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.core import SNOWFLAKE
    from repro_torch.kernels.conv2d.kernel import (conv2d_strips_cuda,
                                                   conv2d_virtual_cuda)
    from repro_torch.kernels.matmul.kernel import matmul_cuda
    from repro_torch.launch import serve
    from repro_torch.models import cnn
    program = cnn.compile_program(CNN_REGISTRY["alexnet-owt"], batch=SLOTS,
                                  hw=SNOWFLAKE, paper_faithful=True)
    counters = {"conv2d_strips": conv2d_strips_cuda,
                "conv2d_virtual": conv2d_virtual_cuda, "matmul": matmul_cuda}
    for fn in counters.values():
        fn.launches = 0
    reset_matmul_paths()
    res = serve.serve_cnn("alexnet-owt", slots=SLOTS, requests=REQUESTS,
                          device=device, seed=SEED, program=program)
    launches = {k: fn.launches for k, fn in counters.items()}
    eng, done = res["engine"], res["done"]
    if eng.program is not program:
        fail("5i: the engine did not serve the Program it was given")
    if len(done) != REQUESTS or not all(r.done for r in done):
        fail(f"5i: served {len(done)} of {REQUESTS} requests")
    kinds = [op.kernel for op in program.ops]
    if (kinds.count("conv2d"), kinds.count("matmul")) != (5, 3):
        fail(f"5i: the Program lists {kinds}")
    want = {"conv2d_strips": eng.n_ticks * 5, "conv2d_virtual": 0,
            "matmul": eng.n_ticks * 3}
    print(f"5i paper-faithful: {eng.n_ticks} ticks, launches {launches}, "
          f"want {want}")
    if launches != want:
        fail(f"5i: launch counts {launches} != {want}")
    check_matmul_paths("5i paper-faithful", want["matmul"], 0)
    n_cmp = check_classes(res, device, "5i")
    img_s = REQUESTS / res["seconds"]
    tick_ms = 1e3 * res["seconds"] / eng.n_ticks
    print(f"5i paper-faithful: {n_cmp}/{REQUESTS} class ids compared, all "
          f"equal to the plain path; {img_s:.1f} img/s ({res['seconds']:.3f}"
          f" s, {tick_ms:.3f} ms a tick) against 5a's zero-copy "
          f"{virtual_img_s:.1f} img/s", flush=True)
    # The two Programs in turns on the same images (zero-copy,
    # paper-faithful, paper-faithful, zero-copy): 5a ran first and
    # alone, so its reading and 5i's are not a like-for-like pair.
    turns = {"zero-copy": [], "paper-faithful": []}
    for kind in ("zero-copy", "paper-faithful", "paper-faithful",
                 "zero-copy"):
        r = serve.serve_cnn("alexnet-owt", slots=SLOTS, requests=REQUESTS,
                            device=device, seed=SEED,
                            program=program if kind == "paper-faithful"
                            else None)
        turns[kind].append(REQUESTS / r["seconds"])
    print("5i in turns: " + ", ".join(
        f"{k} {' and '.join(f'{v:.1f}' for v in vs)} img/s"
        for k, vs in turns.items()), flush=True)
    return launches, img_s, tick_ms


def resnet18_forward(device, hw=None, paper_faithful=False):
    """One resnet18 batch-8 forward, kernels against plain; returns the
    strip launches it made."""
    import torch
    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.core import TPU_V5E
    from repro_torch.kernels.conv2d.kernel import conv2d_strips_cuda
    from repro_torch.models import cnn, init_params
    from repro_torch.runtime import executor
    cfg = CNN_REGISTRY["resnet18"]
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    params = init_params(cnn.param_defs(cfg), gen, device)
    x = torch.randn((SLOTS, 224, 224, 3), generator=gen, device=device)
    program = cnn.compile_program(cfg, batch=SLOTS, hw=hw or TPU_V5E,
                                  paper_faithful=paper_faithful)
    n0 = conv2d_strips_cuda.launches
    reset_matmul_paths()
    ker = executor.run(program, params, x, impl="cuda")
    strips = conv2d_strips_cuda.launches - n0
    check_matmul_paths(f"resnet18 ({program.hw_name})", sum(
        op.kernel == "matmul" for op in program.ops), 0)
    ref = executor.run(program, params, x, impl="reference")
    err = max_err(ker, ref)
    print(f"resnet18 batch {SLOTS} ({program.hw_name}, paper_faithful="
          f"{paper_faithful}): logits {tuple(ker.shape)}, max |err| "
          f"{err:.3e} against the plain path, {strips} strip launches")
    return strips


# --- the smollm-360m serving path ------------------------------------------------
def lm_pairs(arch=LM_ARCH):
    """An LM config and its (prefill, decode) pairs at the main path's
    geometry: smollm-360m plain and windowed, another arch as it is."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config(arch)
    cfgs = [("full", cfg)]
    if arch == LM_ARCH:
        cfgs.append(("window", dataclasses.replace(cfg,
                                                   attn_window=LM_WINDOW)))
    return cfg, {name: transformer.compile_program_pair(
        c, slots=SLOTS, max_len=LM_MAX_LEN) for name, c in cfgs}


def _weight_shape(defs, key):
    path, _, idx = key.partition(":")
    d = defs
    for part in path.split("/"):
        d = d[part]
    return d.shape[1:] if idx else d.shape


def lm_op_descs(cfg, pairs):
    """(distinct ops by description, per (pair, program) op counts)."""
    from repro_torch.models import param_defs
    defs = param_defs(cfg)
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


def lm_flash_case(op, dtype, device, gen, offset=False):
    """The kernel, plain and library callables of one flash op at the
    served width, with its FLOPs and bytes; ``offset``: the operands in
    buffers off a 16-byte boundary (``unaligned``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_plain)
    a, S = op.attn, LM_MAX_LEN

    def heads(H):                    # the executor's (B, S, H, D) layout
        t = torch.randn((1, S, H, a.head_dim), generator=gen,
                        device=device).to(dtype).transpose(1, 2)
        return unaligned(t) if offset else t
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


def lm_decode_case(op, cache, dtype, device, gen, kv_dtype=None):
    """One decode op: q in ``dtype``, the cache in ``kv_dtype`` (default
    ``dtype``; ``torch.float8_e4m3fn`` for the config's float8 caches)."""
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
                          generator=gen, device=device).to(kv_dtype or dtype)
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


def check_lm_kernels(device, peaks, arch=LM_ARCH):
    """Phase 4, every distinct flash, decode and matmul op of ``arch``'s
    pairs; returns (rows by description, per (pair, program) op
    counts)."""
    import torch
    from repro_torch.kernels.decode_attention.kernel import decode_plan
    from repro_torch.kernels.matmul.kernel import matmul_plan
    cfg, pairs = lm_pairs(arch)
    ops, uses = lm_op_descs(cfg, pairs)
    fwd_paths = flash_wrappers()[0].path_launches
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
            before = dict(fwd_paths)
            errs.append(max_err(kern(), plain(), tol))
            if kernel == "flash_attention":
                # f32 on simt, bf16 (the served type) on mma.
                taken = [k for k in fwd_paths if fwd_paths[k] > before[k]]
                want = "simt" if dtype == torch.float32 else "mma"
                if taken != [want]:
                    fail(f"flash {desc} {dtype}: ran on {taken}, not "
                         f"{want}")
        if kernel == "decode_attention":
            # A float8 e4m3 cache (kv_dtype="float8") under bf16 and f32
            # q: widened to f32 inside the kernel, the plain version on
            # the same float8 values.
            for dtype, tol in ((torch.bfloat16, BF16_TOL),
                               (torch.float32, TOL)):
                gen = torch.Generator(device=device).manual_seed(SEED + i)
                fp8 = lm_decode_case(op, shape[0], dtype, device, gen,
                                     kv_dtype=torch.float8_e4m3fn)
                errs.append(max_err(fp8[0](), fp8[1](), tol))
            del fp8
        if kernel == "flash_attention":
            # bf16 on simt too, through operands off a 16-byte boundary.
            gen = torch.Generator(device=device).manual_seed(SEED + i)
            case = lm_flash_case(op, torch.bfloat16, device, gen, offset=True)
            before = fwd_paths["simt"]
            errs.append(max_err(case[0](), case[1](), BF16_TOL))
            if fwd_paths["simt"] != before + 1:
                fail(f"flash {desc} unaligned bf16 did not run on simt")
        name = "flash_attention" if kernel == "flash_attention" else kernel
        row = {"kernel": name, "shape": desc, "err_f32": errs[0],
               "err_bf16": errs[1], "max_abs_err": max(errs),
               "ms": time_ms(kern), "plain_ms": time_ms(plain),
               "library_ms": time_ms(library),
               "flop_ms": flops / peaks["bfloat16"] * 1e3,
               "byte_ms": nbytes / peaks["hbm"] * 1e3}
        row["bound_ms"] = max(row["flop_ms"], row["byte_ms"])
        extra = ""
        if kernel == "matmul":
            row["path"] = matmul_plan(*shape, torch.bfloat16).path
            name = f"matmul/{row['path']}"
        elif kernel == "flash_attention":
            name = "flash/mma"
            extra = f" bf16 simt={errs[2]:.2e}"
        else:
            a = op.attn
            extra = (f" float8 cache: bf16 q {errs[2]:.2e}, f32 q "
                     f"{errs[3]:.2e}; " + plan_text(decode_plan(
                         SLOTS, a.heads, a.kv_heads, shape[0], a.head_dim,
                         torch.bfloat16)))
        rows[desc] = row
        print(f"  {name:16s} err f32={errs[0]:.2e} bf16={errs[1]:.2e}{extra} "
              f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} "
              f"lib={row['library_ms']:.4f} bound={row['bound_ms']:.4f} "
              f"| {desc}", flush=True)
        del case, kern, plain, library
    return rows, uses


def paged_operands(pool_dtype, q_dtype, device, gen, D=None):
    """Phase 4's paged decode operands at the served geometry: (257, 16,
    5, 64) pools (head dim ``D`` where given), q for 8 sequences of
    ``_kv_lens(512)`` rows through a table of shuffled page ids -- the
    two full (wrapped) rings share their first 16 pages, sequences 3 and
    4 their first 8 -- and the null page 0 past each sequence's pages, as
    the PagePool leaves it."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.quant import int8_quantize_pages
    cfg = get_config(LM_ARCH)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, D or cfg.hd
    lens = _kv_lens(LM_MAX_LEN)
    q = torch.randn((SLOTS, Hq, D), generator=gen, device=device).to(q_dtype)
    kp, vp = (torch.randn((N_PAGES, PAGE_SIZE, Hkv, D), generator=gen,
                          device=device) for _ in range(2))
    ids = (torch.randperm(N_PAGES - 1, generator=gen, device=device)
           + 1).tolist()
    table = torch.zeros((SLOTS, LM_MAX_LEN // PAGE_SIZE), dtype=torch.int32)
    for b, n in enumerate(lens):
        for i in range(-(-n // PAGE_SIZE)):
            table[b, i] = ids.pop()
    table[6, :16] = table[5, :16]
    table[4, :8] = table[3, :8]
    scales = {}
    if pool_dtype == torch.int8:
        (kp, scales["k_scale"]), (vp, scales["v_scale"]) = map(
            int8_quantize_pages, (kp, vp))
    else:
        kp, vp = kp.to(pool_dtype), vp.to(pool_dtype)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=device)
    return q, kp, vp, table.to(device), kv_len, scales


def paged_case(pool_dtype, q_dtype, device, gen, peaks):
    """One paged decode check: the kernel against its plain version
    (gather_pages + decode_attention_ref), and the callables timed beside
    it -- the contiguous kernel and SDPA (the library yardstick), both
    over the already-gathered (B, Hkv, S, D) view, so neither pays the
    gather.  The bound counts each distinct live page row once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import gather_pages
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda, decode_plan, paged_decode_attention_cuda,
        paged_decode_attention_plain)
    q, kp, vp, table, kv_len, scales = paged_operands(pool_dtype, q_dtype,
                                                      device, gen)
    B, Hq, D = q.shape
    Hkv, scale = kp.shape[2], D ** -0.5
    kern = lambda: paged_decode_attention_cuda(q, kp, vp, table, kv_len,
                                               scale=scale, **scales)
    plain = lambda: paged_decode_attention_plain(q, kp, vp, table, kv_len,
                                                 scale=scale, **scales)
    k = gather_pages(kp, table, scales.get("k_scale")).to(q_dtype)
    v = gather_pages(vp, table, scales.get("v_scale")).to(q_dtype)
    contiguous = lambda: decode_attention_cuda(q, k, v, kv_len, scale=scale)
    mask = (torch.arange(k.shape[2], device=device)[None, :]
            < kv_len[:, None])[:, None, None, :]
    library = lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, scale=scale,
        enable_gqa=True)[:, :, 0]
    lens = kv_len.tolist()
    tab = table.tolist()
    rows = {(tab[b][r // PAGE_SIZE], r % PAGE_SIZE)
            for b, n in enumerate(lens) for r in range(n)}
    pages = {p for p, _ in rows}
    nbytes = (2 * len(rows) * Hkv * D * kp.element_size()
              + 2 * q.numel() * q.element_size()
              + 4 * (B + sum(-(-n // PAGE_SIZE) for n in lens))
              + (8 * len(pages) if scales else 0))
    flops = 4 * D * Hq * sum(lens)
    tol = TOL if q_dtype == torch.float32 else BF16_TOL
    err = max_err(kern(), plain(), tol)
    plan = decode_plan(B, Hq, Hkv, table.shape[1] * PAGE_SIZE, D, q_dtype,
                       kv_dtype=pool_dtype, page_size=PAGE_SIZE)
    peak = peaks["float32" if q_dtype == torch.float32 else "bfloat16"]
    row = {"pools": str(pool_dtype).removeprefix("torch."),
           "q": str(q_dtype).removeprefix("torch."), "max_abs_err": err,
           "ms": time_ms(kern), "plain_ms": time_ms(plain),
           "contiguous_ms": time_ms(contiguous),
           "library_ms": time_ms(library),
           "flop_ms": flops / peak * 1e3,
           "byte_ms": nbytes / peaks["hbm"] * 1e3,
           "live_rows": len(rows), "bytes": nbytes, "plan": plan_text(plan)}
    row["bound_ms"] = max(row["flop_ms"], row["byte_ms"])
    return row


def check_paged_kernel(device, peaks):
    """Phase 4, the paged decode op: f32 pools (1e-4), bf16 pools and
    int8 pools with bf16 q (2^-7); returns the rows by pool type."""
    import torch
    rows = {}
    for i, (pool_dtype, q_dtype) in enumerate((
            (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
            (torch.int8, torch.bfloat16))):
        gen = torch.Generator(device=device).manual_seed(SEED + 100 + i)
        row = paged_case(pool_dtype, q_dtype, device, gen, peaks)
        rows[row["pools"]] = row
        print(f"  paged_decode_attention {row['pools']} pools, {row['q']} q, "
              f"{row['plan']}: err={row['max_abs_err']:.2e} ms={row['ms']:.4f} "
              f"plain={row['plain_ms']:.4f} contiguous kernel="
              f"{row['contiguous_ms']:.4f} library (SDPA over the "
              f"already-gathered view)={row['library_ms']:.4f} "
              f"bound={row['bound_ms']:.4f} ({row['live_rows']} distinct "
              f"live rows, {row['bytes']} B) | lens "
              f"{_kv_lens(LM_MAX_LEN)} pools ({N_PAGES}, {PAGE_SIZE}, 5, 64)",
              flush=True)
    # Head dim 112 (zamba2-7b's), which pages on the card since the split
    # kernels: bf16 and int8 pools with bf16 q, checked, not timed.
    from repro_torch.kernels.decode_attention.kernel import (
        decode_plan, paged_decode_attention_cuda,
        paged_decode_attention_plain)
    for i, pool_dtype in enumerate((torch.bfloat16, torch.int8)):
        gen = torch.Generator(device=device).manual_seed(SEED + 110 + i)
        q, kp, vp, table, kv_len, scales = paged_operands(
            pool_dtype, torch.bfloat16, device, gen, D=112)
        kw = dict(scale=112 ** -0.5, **scales)
        err = max_err(paged_decode_attention_cuda(q, kp, vp, table, kv_len,
                                                  **kw),
                      paged_decode_attention_plain(q, kp, vp, table, kv_len,
                                                   **kw), BF16_TOL)
        rows[f"D112 {pool_dtype}"] = {"max_abs_err": err}
        plan = decode_plan(*q.shape[:2], kp.shape[2], table.shape[1]
                           * PAGE_SIZE, 112, q.dtype, kv_dtype=pool_dtype,
                           page_size=PAGE_SIZE)
        print(f"  paged_decode_attention D=112 {pool_dtype} pools, bf16 q, "
              f"{plan_text(plan)}: err={err:.2e} (untimed)", flush=True)
    return rows


def plan_text(plan) -> str:
    """A decode plan as phase 4 prints it."""
    return (f"plan {plan.splits} x {plan.split_rows} rows (tiles of "
            f"{plan.tile_rows}), {plan.grid[0] * plan.grid[1]} CTAs")


# (Bt, L, H, P, N, with h0, timed as): zamba2-7b's admission (h0 zero, as
# a prefill starts) and decode tick, an L that is not a multiple of the
# kernels' 64-step chunk, and a 2048-row prompt (32 chunks).
SSD_CASES = [(1, 512, 112, 64, 64, False, "admission"),
             (1, 512, 112, 64, 64, True, None),
             (8, 1, 112, 64, 64, True, "tick"),
             (1, 300, 112, 64, 64, True, None),
             (1, 2048, 112, 64, 64, True, "L2048")]
# (B, L, H, D, with s0, timed as): rwkv6-7b's admission, a short L, a
# 2048-row prompt, and head dim 48 (no power of two).
WKV_CASES = [(1, 512, 64, 64, False, "admission"),
             (1, 512, 64, 64, True, None), (8, 5, 64, 64, True, None),
             (1, 2048, 64, 64, True, "L2048"),
             (1, 512, 64, 48, True, "D48")]


def ssd_chunk_flops(Bt, L, H, P, N, dtype):
    """(FLOP, TF32 tensor-core FLOP issued) of ``ssd_plan``'s chunked form:
    per chunk of q rows, the local state (B o w)^T x (2 q N P), C B^T and
    G x on the causal half (q (q + 1) N and q (q + 1) P) and C S (2 q N
    P); 3xTF32 issues each f32 product three times, and a product with a
    bf16 side (exact in TF32) twice, C B^T of bf16 operands once.  None
    on the step path, which has no chunk products."""
    import torch
    from repro_torch.kernels.mamba2.kernel import ssd_plan
    plan = ssd_plan(Bt, L, H, P, N, dtype)
    if plan.path != "chunked":
        return None
    bf = dtype == torch.bfloat16
    flops = issued = 0
    for c in range(plan.n_chunks):
        q = min(plan.chunk, L - c * plan.chunk)
        parts = ((2 * q * N * P, 2 if bf else 3),
                 (q * (q + 1) * N, 1 if bf else 3),
                 (q * (q + 1) * P, 2 if bf else 3),
                 (2 * q * N * P, 2 if bf else 3))
        flops += sum(f for f, _ in parts)
        issued += sum(f * n for f, n in parts)
    return Bt * H * flops, Bt * H * issued


def ssd_plan_text(case, dtype) -> str:
    from repro_torch.kernels.mamba2.kernel import ssd_plan
    plan = ssd_plan(*case[:5], dtype)
    if plan.path == "step":
        return (f"plan step: {plan.grid[0] * plan.grid[1]} CTAs, 1 kernel, "
                f"{plan.smem[0]} B shared")
    return (f"plan chunked: {plan.n_chunks} chunks of {plan.chunk}, "
            f"{plan.grid[0] * plan.grid[1] * plan.grid[2]} CTAs a chunk "
            f"kernel, pass {plan.pass_grid[0] * plan.pass_grid[1]} CTAs, "
            f"cluster {plan.cluster}, {plan.kernels} kernels, shared "
            f"{plan.smem[0]} / {plan.smem[1]} B")


def wkv_plan_text(case, dtype) -> str:
    from repro_torch.kernels.rwkv6.kernel import wkv_plan
    plan = wkv_plan(*case[:4], dtype)
    g = plan.local_grid
    return (f"plan: {plan.n_chunks} chunks of {plan.chunk}, "
            f"{g[0] * g[1] * g[2]} local CTAs ({g[0]} column blocks, "
            f"{plan.rows} rows a thread), pass "
            f"{plan.pass_grid[0] * plan.pass_grid[1]} CTAs, "
            f"{plan.out_grid[0] * plan.out_grid[1] * plan.out_grid[2]} "
            f"output CTAs, cluster {plan.cluster}, {plan.kernels} kernels")


def ssd_case(case, dtype, device, gen):
    """One mamba2_scan check on the model's operands: x, B, C strided
    column slices of one (Bt, L, H*P + 2N) conv output, f32 dt from a
    softplus, A < 0.  Returns (kern, plain, flops, bytes, chunk-form
    work as (peak name, FLOP issued) or None).  The bound counts the
    recurrence's 5 N P f32 FLOP per step and head (decay, outer-product
    update, read-out) and x, B, C, dt, A, h0 read and y and the final
    state written once."""
    import torch
    from repro_torch.kernels.mamba2.kernel import (mamba2_scan_cuda,
                                                   mamba2_scan_plain)
    Bt, L, H, P, N, with_h0, _ = case
    xbc = torch.randn((Bt, L, H * P + 2 * N), generator=gen,
                      device=device).to(dtype)
    x = xbc[..., :H * P].reshape(Bt, L, H, P)
    B, C = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dt = torch.nn.functional.softplus(
        torch.randn((Bt, L, H), generator=gen, device=device))
    A = -torch.exp(torch.randn((H,), generator=gen, device=device) * 0.5)
    h0 = (torch.randn((Bt, H, N, P), generator=gen, device=device)
          if with_h0 else None)
    kern = lambda: mamba2_scan_cuda(x, dt, A, B, C, h0=h0)
    plain = lambda: mamba2_scan_plain(x, dt, A, B, C, h0=h0)
    es = x.element_size()
    nbytes = (es * (2 * Bt * L * H * P + 2 * Bt * L * N) + 4 * Bt * L * H
              + 4 * H + 4 * Bt * H * N * P * (2 if with_h0 else 1))
    chunk = ssd_chunk_flops(Bt, L, H, P, N, dtype)
    return kern, plain, 5 * N * P * Bt * L * H, nbytes, (
        None if chunk is None else ("tfloat32", chunk[1]))


def wkv_case(case, dtype, device, gen):
    """One wkv6 check: r, k, v, w (w = exp(-exp(.)) in (0, 1)) in the
    model's (B, L, H, D) layout, u (H, D).  Returns (kern, plain, flops,
    bytes, chunk-form work as (peak name, FLOP)).  The bound counts 5 D^2
    f32 FLOP per step and head (read-out and decayed rank-1 update) and
    r, k, v, w, u, s0 read and y and the final state written once; the
    chunk form adds what the chunked kernels compute beyond it -- the
    state pass (2 D^2 a chunk) and the output product (r o a)^T S (2 D^2
    a step) -- at the f32 FMA rate."""
    import torch
    from repro_torch.kernels.rwkv6.kernel import (wkv6_cuda, wkv6_plain,
                                                  wkv_plan)
    B, L, H, D, with_s0, _ = case

    def rows():
        return torch.randn((B, L, H, D), generator=gen, device=device)
    r, k, v = (rows().to(dtype) for _ in range(3))
    w = torch.exp(-torch.exp(rows() * 0.5)).to(dtype)
    u = torch.randn((H, D), generator=gen, device=device).to(dtype)
    s0 = (torch.randn((B, H, D, D), generator=gen, device=device)
          if with_s0 else None)
    kern = lambda: wkv6_cuda(r, k, v, w, u, s0=s0)
    plain = lambda: wkv6_plain(r, k, v, w, u, s0=s0)
    nbytes = (r.element_size() * (5 * B * L * H * D + H * D)
              + 4 * B * H * D * D * (2 if with_s0 else 1))
    nc = wkv_plan(B, L, H, D, dtype).n_chunks
    return kern, plain, 5 * D * D * B * L * H, nbytes, (
        "float32", B * H * D * D * (7 * L + 2 * nc))


def check_ssm_kernels(device, peaks):
    """Phase 4, the recurrent kernels: each case in f32 (atol = rtol =
    1e-4) and bf16 (2^-7, y; the f32 state at 1e-4), against the plain
    version (the sequential f32 recurrence, y rounded once), with the
    plan it ran on; the served shapes, L = 2048 and wkv6's D = 48 timed
    in bf16, per launch, beside the plain version and the bounds.  No
    single PyTorch call computes either function, so neither has a
    library yardstick.  Returns {kernel: {"max_abs_err": e, "rows":
    {timed as: row}}}."""
    import torch
    out = {}
    for kernel, cases, make, text in (
            ("mamba2_scan", SSD_CASES, ssd_case, ssd_plan_text),
            ("wkv6", WKV_CASES, wkv_case, wkv_plan_text)):
        errs, rows = [], {}
        for i, case in enumerate(cases):
            for dtype, tol in ((torch.float32, TOL),
                               (torch.bfloat16, BF16_TOL)):
                gen = torch.Generator(device=device).manual_seed(
                    SEED + 300 + i)
                kern, plain, flops, nbytes, chunk = make(case, dtype,
                                                         device, gen)
                (y, s), (y_ref, s_ref) = kern(), plain()
                err = max(max_err(y, y_ref, tol), max_err(s, s_ref))
                errs.append(err)
                print(f"  {kernel} {case[:-1]} "
                      f"{str(dtype).removeprefix('torch.')}: max |err| "
                      f"{err:.2e}; {text(case, dtype)}", flush=True)
            timed = case[-1]
            if timed is not None:
                # The plain version is a Python loop of ~6 ops per step:
                # two calls (some 6,000 launches at L = 512) in the graph.
                row = {"ms": time_ms(kern),
                       "plain_ms": time_ms(plain, reps=2, warmup=1),
                       "library_ms": None,
                       "flop_ms": flops / peaks["float32"] * 1e3,
                       "byte_ms": nbytes / peaks["hbm"] * 1e3,
                       "chunk_ms": (None if chunk is None else
                                    chunk[1] / peaks[chunk[0]] * 1e3),
                       "flops": flops, "bytes": nbytes}
                row["bound_ms"] = max(row["flop_ms"], row["byte_ms"])
                rows[timed] = row
                chunk_ms = ("none (step path)" if chunk is None else
                            f"{row['chunk_ms']:.4f}")
                unit = "TF32 tensor-core" if kernel == "mamba2_scan" else \
                    "f32 FMA"
                print(f"  {kernel} bf16 {case[:-1]} ({timed}): "
                      f"ms={row['ms']:.4f} a launch, plain="
                      f"{row['plain_ms']:.4f} bound={row['bound_ms']:.4f} "
                      f"({flops / 1e9:.3f} GFLOP f32, {nbytes / 1e6:.2f} "
                      f"MB); chunk-form bound at the {unit} rate {chunk_ms}",
                      flush=True)
            del kern, plain, y, s, y_ref, s_ref
        out[kernel] = {"max_abs_err": max(errs), "rows": rows}
    return out


def _train_heads(B, S, H, dtype, device, gen, D):
    """(B, H, S, D) operands in the model's transposed (B, S, H, D)
    layout, as the legacy forward hands them to the kernels."""
    import torch
    return torch.randn((B, S, H, D), generator=gen, device=device).to(
        dtype).transpose(1, 2)


def bwd_magnitudes(q, k, v, out, lse, do, *, scale, causal, window,
                   kv_len):
    """Each of (dq, dk, dv)'s sum of absolute terms in the plain backward:
    the same products on |operands| with dP - delta taken as
    |dO| |V|^T + rowsum(|dO * O|), so every rounding error of the f32
    computation, dP's and delta's included, is bounded by the unit
    roundoff times the longest sum's length times this."""
    import torch
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    f = lambda t: t.float()
    kk = f(k).repeat_interleave(G, 1)
    vv = f(v).repeat_interleave(G, 1)
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Skv, device=q.device)[None, :]
    ok = ki < (Skv if kv_len is None else kv_len)
    if causal:
        ok = ok & (ki <= qi)
    if window:
        ok = ok & (ki > qi - window)
    s = (f(q) @ kk.transpose(-1, -2)) * scale
    pr = torch.exp(s.masked_fill(~ok, -1e30) - lse[..., None])
    a = pr * ((f(do).abs() @ vv.abs().transpose(-1, -2))
              + (f(do) * f(out)).abs().sum(-1, keepdim=True)) * scale
    return (a @ kk.abs(),
            (a.transpose(-1, -2) @ f(q).abs()).reshape(
                B, Hkv, G, Skv, D).sum(2),
            (pr.transpose(-1, -2) @ f(do).abs()).reshape(
                B, Hkv, G, Skv, D).sum(2))


def check_flash_bwd(device, peaks):
    """Phase 4, the flash-attention backward at the training shape (B = 8,
    15 q / 5 kv heads of 64, S = 512): causal, window 128 and a
    kv_len = 450 mask (non-causal), in f32 (atol = rtol = 1e-4) and bf16
    (one bf16 ulp of the plain result plus the f32 rounding bound of its
    sums, ``max_err_ulp`` with ``bwd_slack`` x ``bwd_magnitudes``), each
    on the forward kernel's out and lse, against the plain version; the
    causal bf16 case also on simt (operands off a 16-byte boundary) at
    one bf16 ulp; the trainable wrapper's gradients against flash_ref's
    autograd in f32 at batch 2; then the causal bf16 case timed with the
    forward kernel at the same shape, SDPA's forward and SDPA's backward.
    Each bf16 case also prints, of the kernel and of the plain version
    with its key chunk cut from 512 to 64 (the same f32 sums in another
    order), how many elements lie past one ulp and the largest share of
    the f32 bound an element uses past that ulp.  Returns the timed
    row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, flash_ref
    from repro_torch.kernels.flash_attention.bwd_kernel import (
        flash_attention_bwd_cuda, flash_attention_bwd_plain)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda, flash_attention_plain)
    from repro_torch.kernels.flash_attention.ref import flash_bwd_ref
    from repro_torch.configs import get_config
    cfg = get_config(LM_ARCH)
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    B, S = TRAIN_BATCH, TRAIN_SEQ
    scale = D ** -0.5
    errs, row = [], None
    cases = (("causal", True, None, None), ("window 128", True, 128, None),
             ("kv_len 450", False, None, 450))
    for i, (label, causal, window, kv_len) in enumerate(cases):
        kw = dict(scale=scale, causal=causal, window=window, kv_len=kv_len)
        for dtype in (torch.float32, torch.bfloat16):
            gen = torch.Generator(device=device).manual_seed(SEED + 200 + i)
            q, do = (_train_heads(B, S, Hq, dtype, device, gen, D)
                     for _ in range(2))
            k, v = (_train_heads(B, S, Hkv, dtype, device, gen, D)
                    for _ in range(2))
            out, lse = flash_attention_cuda(q, k, v, **kw)
            kern = lambda: flash_attention_bwd_cuda(q, k, v, out, lse, do,
                                                    **kw)
            plain = lambda: flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                      **kw)
            got, want = kern(), plain()
            if dtype == torch.float32:
                err = max(max_err(g, w) for g, w in zip(got, want))
                note = "tolerance 1e-4"
            else:
                mags = bwd_magnitudes(q, k, v, out, lse, do, **kw)
                slack = bwd_slack(S, D)
                err, worst = map(max, zip(*(
                    max_err_ulp(g, w, slack * m)
                    for g, w, m in zip(got, want, mags))))
                reorder = flash_bwd_ref(q, k, v, out, lse, do, chunk=64,
                                        **kw)
                past = lambda xs: "; ".join(
                    "%d past, %.4f" % past_ulp(a, w, slack * m)
                    for a, w, m in zip(xs, want, mags))
                note = (f"tolerance one bf16 ulp + {slack:.3e} x the sum "
                        f"of absolute terms, worst element at {worst:.3f} "
                        f"of it; dq/dk/dv elements past one ulp and the "
                        f"largest share of the f32 bound used past it: "
                        f"kernel {past(got)}; plain version with 64-key "
                        f"chunks {past(reorder)}")
                del mags, reorder
                if label == "causal":
                    # simt in bf16 too: operands off a 16-byte boundary.
                    simt = flash_attention_bwd_cuda.path_launches["simt"]
                    got_simt = flash_attention_bwd_cuda(
                        *map(unaligned, (q, k, v, out)), lse, unaligned(do),
                        **kw)
                    if flash_attention_bwd_cuda.path_launches["simt"] != (
                            simt + 1):
                        fail("flash_attention_bwd unaligned bf16 did not "
                             "run on simt")
                    err_simt = max(max_err_ulp(g, w)[0]
                                   for g, w in zip(got_simt, want))
                    errs.append(err_simt)
                    note += (f"; simt (operands off a 16-byte boundary) "
                             f"max |err| {err_simt:.2e} (tolerance one "
                             f"bf16 ulp)")
                    del got_simt
            errs.append(err)
            print(f"  flash_attention_bwd {label} "
                  f"{str(dtype).removeprefix('torch.')}: dq/dk/dv max |err| "
                  f"{err:.2e} ({note})", flush=True)
            if label == "causal" and dtype == torch.bfloat16:
                qi = torch.arange(S, device=device)
                pairs = int((qi[None, :] <= qi[:, None]).sum())
                n_q = B * Hq * S * D
                n_kv = B * Hkv * S * D
                # The function's own work: q, k, v, out, dO and lse read
                # once and dq, dk, dv written once; 5 products of 2 D FLOP
                # per unmasked pair (S, dP, dV, dK, dQ).  The kernel's
                # delta scratch and its dQ pass's second S and dP are its
                # own choices, not the function's, so they are not counted.
                nbytes = (q.element_size() * (4 * n_q + 4 * n_kv)
                          + 4 * B * Hq * S)
                flops = 5 * 2 * D * pairs * B * Hq
                fwd = lambda: flash_attention_cuda(q, k, v, **kw)
                leaves = [t.detach().clone().requires_grad_()
                          for t in (q, k, v)]
                sdpa = lambda: F.scaled_dot_product_attention(
                    *leaves, is_causal=True, scale=scale, enable_gqa=True)
                sdpa_bwd = lambda: torch.autograd.grad(sdpa(), leaves, do)
                # The forward at the same shape: q, k, v read, out and
                # lse written; 2 products of 2 D FLOP per unmasked pair.
                fwd_bytes = (q.element_size() * (2 * n_q + 2 * n_kv)
                             + 4 * B * Hq * S)
                fwd_flops = 2 * 2 * D * pairs * B * Hq
                sdpa_ms = time_ms(sdpa)
                row = {"ms": time_ms(kern), "plain_ms": time_ms(plain),
                       "fwd_ms": time_ms(fwd),
                       "fwd_plain_ms": time_ms(
                           lambda: flash_attention_plain(q, k, v, **kw)),
                       "fwd_library_ms": sdpa_ms,
                       "fwd_bound_ms": max(
                           fwd_flops / peaks["bfloat16"] * 1e3,
                           fwd_bytes / peaks["hbm"] * 1e3),
                       "library_ms": time_ms(sdpa_bwd) - sdpa_ms,
                       "flop_ms": flops / peaks["bfloat16"] * 1e3,
                       "byte_ms": nbytes / peaks["hbm"] * 1e3,
                       "flops": flops, "bytes": nbytes}
                row["bound_ms"] = max(row["flop_ms"], row["byte_ms"])
            del got, want, kern, plain
    # The trainable wrapper (forward kernel + backward kernel under
    # autograd) against flash_ref's own autograd, f32, batch 2.
    gen = torch.Generator(device=device).manual_seed(SEED + 210)
    q, do = (_train_heads(2, S, Hq, torch.float32, device, gen, D)
             for _ in range(2))
    k, v = (_train_heads(2, S, Hkv, torch.float32, device, gen, D)
            for _ in range(2))
    grads = []
    for fn in (lambda *t: flash_attention(*t, causal=True, impl="cuda"),
               lambda *t: flash_ref(*t, causal=True)):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        grads.append(torch.autograd.grad(fn(*leaves), leaves, do))
    err = max(max_err(g, w) for g, w in zip(*grads))
    errs.append(err)
    print(f"  flash_attention autograd (forward + backward kernels) against "
          f"flash_ref's autograd, f32, batch 2: max |err| {err:.2e}")
    row["max_abs_err"] = max(errs)
    print(f"  flash_attention_bwd bf16 causal B={B} S={S} {Hq}/{Hkv}x{D}: "
          f"ms={row['ms']:.4f} plain={row['plain_ms']:.4f} library (SDPA "
          f"fwd+bwd minus fwd)={row['library_ms']:.4f} "
          f"bound={row['bound_ms']:.4f} ({row['flops'] / 1e9:.2f} GFLOP, "
          f"{row['bytes'] / 1e6:.2f} MB); forward kernel at the same shape "
          f"{row['fwd_ms']:.4f} ms (plain {row['fwd_plain_ms']:.4f}, SDPA "
          f"{row['fwd_library_ms']:.4f}, bound {row['fwd_bound_ms']:.4f})",
          flush=True)
    return row


def _tree_equal(a, b) -> bool:
    """Every leaf bit for bit (bf16 compared as its 16-bit words)."""
    import torch
    from repro_torch.checkpoint import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    bits = lambda t: t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(bits(x), bits(y))
        for x, y in zip(la, lb))


def train_smoke(device):
    """Phase 5f, first: ``repro_torch.launch.train --smoke`` takes one step
    of the smoke config as it is (head dim 16, f32, 4 layers without
    remat), counters set to 0 just before and read just after: one flash
    forward and one backward launch per layer and a finite loss; then the
    same config's loss and gradients through the kernels against the
    plain path at 1e-4.  Returns the launches."""
    import math
    import shutil
    import tempfile
    import torch
    from repro_torch.launch import train
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import init_params, transformer
    counters = lm_counters()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_smoke_")
    try:
        for fn in counters.values():
            fn.launches = 0
        reset_flash_paths()
        res = train.main(["--arch", LM_ARCH, "--smoke", "--steps", "1",
                          "--batch", "2", "--seq", "64", "--ckpt-dir",
                          ckpt_dir, "--ckpt-every", "1", "--seed",
                          str(SEED)])
        launches = {k: fn.launches for k, fn in counters.items()}
        # The smoke config is f32: both flash kernels on simt.
        check_flash_paths("5f smoke", res["cfg"].n_layers,
                          res["cfg"].n_layers, path="simt")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = res["cfg"]
    L = cfg.n_layers
    want = {k: 0 for k in counters}
    want.update(flash_attention=L, flash_attention_bwd=L)
    loss = res["trainer"].metrics_history[0]["loss"]
    print(f"5f smoke: head dim {cfg.head_dim}, {L} layers, one step, loss "
          f"{loss:.4f}, launches {launches}, want {want}")
    if cfg.head_dim != 16 or launches != want or not math.isfinite(loss):
        fail("5f smoke: the smoke step did not run on the flash kernels")
    params = init_params(transformer.param_defs(cfg),
                         torch.Generator(device).manual_seed(SEED))
    gen = torch.Generator(device).manual_seed(SEED + 1)
    batch = {k: torch.randint(0, cfg.vocab, (2, 64), generator=gen,
                              device=device) for k in ("tokens", "labels")}
    b0 = counters["flash_attention_bwd"].launches
    loss_k, grads_k = loss_and_grads(cfg, params, batch, impl="auto")
    if counters["flash_attention_bwd"].launches - b0 != L:
        fail("5f smoke: the kernel-path gradients missed the backward kernel")
    loss_r, grads_r = loss_and_grads(cfg, params, batch, impl="reference")
    err = max([max_err(loss_k, loss_r)] + [
        max_err(g, grads_r_leaf) for g, grads_r_leaf in zip(
            _named_leaves(grads_k).values(),
            _named_leaves(grads_r).values())])
    print(f"5f smoke: loss and every gradient through the kernels within "
          f"{err:.3e} of the plain path (tolerance {TOL})", flush=True)
    return launches


def train_lm(device, bwd_row):
    """Phase 5f: ``repro_torch.launch.train`` in process on full-width
    smollm-360m (bf16, batch 8, seq 512, SyntheticLM seed 0, AdamW with
    the CLI's cosine schedule), counters set to 0 just before it and read
    just after: per step exactly 64 flash forward launches (32 layers,
    each recomputed under remat) and 32 backward, no matmul or decode
    launch; every loss finite.  Then the same params and step-0 batch
    through the plain path on the card (loss within LOSS_RTOL, global
    gradient norm within GNORM_RTOL, each leaf's largest gradient
    difference within LEAF_RTOL of its largest gradient), and a fresh
    trainer resumed from the last checkpoint: at the saved step, with
    params and optimizer state equal bit for bit.  Returns (launches, stats)."""
    import math
    import shutil
    import tempfile
    import torch
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.launch.steps import build_train_step, loss_and_grads
    from repro_torch.models import init_params, transformer
    from repro_torch.optim import AdamW, global_norm
    from repro_torch.runtime import Trainer, TrainerConfig
    counters = lm_counters()
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        for fn in counters.values():
            fn.launches = 0
        reset_flash_paths()
        torch.cuda.reset_peak_memory_stats()
        res = train.main(["--arch", LM_ARCH, "--steps", str(TRAIN_STEPS),
                          "--batch", str(TRAIN_BATCH), "--seq",
                          str(TRAIN_SEQ), "--ckpt-dir", ckpt_dir,
                          "--ckpt-every", str(TRAIN_STEPS),
                          "--seed", str(SEED)])
        launches = {k: fn.launches for k, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        cfg, trainer = res["cfg"], res["trainer"]
        hist = trainer.metrics_history
        L, n = cfg.n_layers, len(hist)
        want = {"flash_attention": 2 * L * n, "flash_attention_bwd": L * n,
                "decode_attention": 0, "paged_decode_attention": 0,
                "matmul": 0, "mamba2_scan": 0, "wkv6": 0}
        print(f"5f train: {n} steps, launches {launches}, want {want}")
        if n != TRAIN_STEPS or res["step"] != TRAIN_STEPS:
            fail(f"5f train: {n} steps recorded, ended at {res['step']}")
        if launches != want:
            fail(f"5f train: launch counts {launches} != {want}")
        check_flash_paths("5f train", 2 * L * n, L * n)
        losses = [r["loss"] for r in hist]
        if not all(math.isfinite(x) for x in losses):
            fail(f"5f train: non-finite loss in {losses}")

        # Step 0 again, kernels against the plain path on the card.
        params = init_params(transformer.param_defs(cfg),
                             torch.Generator(device).manual_seed(SEED))
        batch = {k: torch.from_numpy(v).to(device) for k, v in SyntheticLM(
            vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
            seed=0).batch_at(0).items()}
        got = loss_and_grads(cfg, params, batch, impl="auto", remat=True)
        ref = loss_and_grads(cfg, params, batch, impl="reference",
                             remat=True)
        (loss_k, grads_k), (loss_r, grads_r) = got, ref
        gn_k, gn_r = float(global_norm(grads_k)), float(global_norm(grads_r))
        d_loss = abs(float(loss_k) - float(loss_r)) / abs(float(loss_r))
        d_norm = abs(gn_k - gn_r) / gn_r
        print(f"5f step 0: loss kernels {float(loss_k):.6f} plain "
              f"{float(loss_r):.6f} (trainer {losses[0]:.6f}; rel diff "
              f"{d_loss:.2e}, bound {LOSS_RTOL}); grad norm kernels "
              f"{gn_k:.6f} plain {gn_r:.6f} (rel diff {d_norm:.2e}, bound "
              f"{GNORM_RTOL})")
        named_r = _named_leaves(grads_r)
        leaf_diffs = {}
        for name, gk in _named_leaves(grads_k).items():
            gr = named_r[name]
            leaf_diffs[name] = ((gk.float() - gr.float()).abs().max().item(),
                                gr.float().abs().max().item())
        leaf_rel = {k: d / m for k, (d, m) in leaf_diffs.items()}
        print("5f step 0 per-leaf max |grad diff| (max |grad|; ratio, bound "
              f"{LEAF_RTOL}): " + ", ".join(
                  f"{k} {d:.3e} ({m:.3e}; {leaf_rel[k]:.4f})"
                  for k, (d, m) in leaf_diffs.items()))
        bad = [k for k, r in leaf_rel.items() if not r <= LEAF_RTOL]
        if not (d_loss <= LOSS_RTOL and d_norm <= GNORM_RTOL) or bad:
            fail(f"5f step 0: kernel path disagrees with the plain path "
                 f"(leaves over {LEAF_RTOL}: {bad})")
        del got, ref, grads_k, grads_r

        # A fresh trainer resumes from the last checkpoint.
        optimizer = AdamW()
        fresh = init_params(transformer.param_defs(cfg),
                            torch.Generator(device).manual_seed(SEED + 1))
        resumed = Trainer(build_train_step(cfg, optimizer), None,
                          TrainerConfig(total_steps=TRAIN_STEPS,
                                        ckpt_every=TRAIN_STEPS,
                                        ckpt_dir=ckpt_dir), device=device)
        p2, o2, step2 = resumed.run(fresh, optimizer.init(fresh))
        same = (_tree_equal(p2, res["params"])
                and _tree_equal(o2, res["opt_state"]))
        size = sum(os.path.getsize(os.path.join(dp, f))
                   for dp, _, fs in os.walk(ckpt_dir) for f in fs)
        print(f"5f resume: restored step {step2}, "
              f"{len(resumed.metrics_history)} steps run, params and "
              f"optimizer state bit-equal: {same} "
              f"(checkpoint {size / 1e9:.2f} GB)")
        if step2 != TRAIN_STEPS or resumed.metrics_history or not same:
            fail("5f resume: the checkpoint did not restore the trained state")
        del fresh, p2, o2
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    dts = [r["dt_s"] for r in hist[1:]]
    step_ms = 1e3 * sum(dts) / len(dts)
    profile_step(cfg, res["params"], res["opt_state"], device, step_ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    stats = {"step_ms": step_ms, "tok_s": tokens / (step_ms / 1e3),
             "warmup_ms": 1e3 * hist[0]["dt_s"], "losses": losses,
             "fwd_ms": 2 * L * bwd_row["fwd_ms"], "bwd_ms": L * bwd_row["ms"],
             "peak_gb": peak / 1e9}
    print(f"5f train: {stats['tok_s']:.0f} tokens/s trained, step "
          f"{step_ms:.2f} ms mean over steps 1-{n - 1} (step 0 "
          f"{stats['warmup_ms']:.1f} ms); flash forward {2 * L} x "
          f"{bwd_row['fwd_ms']:.4f} = {stats['fwd_ms']:.2f} ms and backward "
          f"{L} x {bwd_row['ms']:.4f} = {stats['bwd_ms']:.2f} ms of kernel "
          f"time per step; peak memory allocated {stats['peak_gb']:.2f} GB; "
          f"losses {[round(x, 4) for x in losses]}", flush=True)
    return launches, stats


# Device-time groups of a profiled training step, by kernel name.
KERNEL_GROUPS = (("flash forward (CUDA)", ("flash_kernel",
                                             "flash_mma_kernel")),
                 ("flash backward (CUDA)", ("dq_kernel", "dkv_kernel",
                                            "dq_mma_kernel",
                                            "dkv_mma_kernel")),
                 ("cuBLAS GEMMs", ("gemm", "gemv", "xmma", "cutlass",
                                   "cublas", "nvjet")),
                 ("reductions and softmax", ("reduce", "softmax",
                                             "logsumexp")),
                 ("index / scatter / gather", ("index", "scatter",
                                               "gather")))


def profile_step(cfg, params, opt_state, device, step_ms):
    """One more training step under ``torch.profiler``: device time by
    kernel group, the kernel sum against the unprofiled mean step
    (``step_ms``), and the launches.  Prints "not measured" when the
    profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.steps import build_train_step
    from repro_torch.optim import AdamW
    batch = {k: torch.from_numpy(v).to(device) for k, v in SyntheticLM(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
        seed=0).batch_at(TRAIN_STEPS).items()}
    step_fn = build_train_step(cfg, AdamW())
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    del out
    groups, kernels, launches = Counter(), Counter(), 0
    for evt in prof.key_averages():
        if "CUDA" not in str(evt.device_type):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        name = evt.key.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in name for k in keys)), "other elementwise")
        groups[group] += us / 1e3
        kernels[f"{evt.key[:60]} x{evt.count}"] += us / 1e3
        launches += evt.count
    total = sum(groups.values())
    if total <= 0:
        print("5f profile: the profiler saw no device time; breakdown not "
              "measured")
        return None
    print(f"5f profile: one step {wall_ms:.1f} ms under the profiler; "
          f"{launches} kernel launches, {total:.1f} ms of device time = "
          f"{100 * total / step_ms:.0f}% of the unprofiled {step_ms:.1f} ms "
          f"step (device idle {100 * (1 - total / step_ms):.0f}%): " +
          ", ".join(f"{g} {ms:.2f} ms" for g, ms in groups.most_common()))
    print("5f profile, the ten largest kernels: " + "; ".join(
        f"{k} {ms:.2f} ms" for k, ms in kernels.most_common(10)))
    return {"device_ms": total, "launches": launches, "groups": dict(groups),
            "wall_ms": wall_ms}


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in sorted(tree.items())
                for k2, v2 in _named_leaves(v, f"{prefix}/{k}"
                                            if prefix else k).items()}
    return {prefix: tree}


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
    """Wraps the executor's runners and page-table hand-offs while an LM
    main path runs: keeps each call's inputs, in order, with the logits
    rows the engine reads and the call's wall time up to a device
    synchronise (page-table syncs and COW copies are kept to be replayed,
    untimed)."""

    NAMES = ("run_prefill", "run_prefill_chunk", "run_decode",
             "sync_page_table", "apply_page_copies")

    def __init__(self):
        from repro_torch.runtime import executor
        self.ex = executor
        self.orig = {n: getattr(executor, n) for n in self.NAMES}
        self.calls = []

    def __enter__(self):
        import numpy as np
        import torch
        orig = self.orig

        def timed(fn, *args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        def run_prefill(program, params, tokens, state, slot, length,
                        write_from=0, *, impl="auto"):
            out, dt = timed(orig["run_prefill"], program, params, tokens,
                            state, slot, length, write_from, impl=impl)
            self.calls.append(("prefill", dt,
                               (tokens.clone(), slot, length, write_from),
                               {0: out[0, length - 1].clone()}))
            return out

        def run_prefill_chunk(program, params, tokens, state, slot, start,
                              stop, length, write_from=None, *,
                              impl="auto"):
            out, dt = timed(orig["run_prefill_chunk"], program, params,
                            tokens, state, slot, start, stop, length,
                            write_from, impl=impl)
            args = tuple(np.array(x) for x in (slot, start, stop, length,
                                               write_from))
            self.calls.append(("chunk", dt, (tokens.clone(),) + args, {
                i: out[i, n - 1].clone() for i, (s, n) in
                enumerate(zip(args[2], args[3])) if s == n}))
            return out

        def run_decode(program, params, tokens, state, mask=None, *,
                       impl="auto"):
            out, dt = timed(orig["run_decode"], program, params, tokens,
                            state, mask, impl=impl)
            self.calls.append(("decode", dt, (tokens.clone(), mask.clone()),
                               {i: out[i].clone() for i in
                                mask.nonzero().flatten().tolist()}))
            return out

        def sync_page_table(state, pair, pool):
            if pool.dirty:
                self.calls.append(("table", 0.0, pool.table.copy(), {}))
            return orig["sync_page_table"](state, pair, pool)

        def apply_page_copies(state, pair, copies):
            if copies:
                self.calls.append(("copies", 0.0, list(copies), {}))
            return orig["apply_page_copies"](state, pair, copies)
        wrappers = {"run_prefill": run_prefill,
                    "run_prefill_chunk": run_prefill_chunk,
                    "run_decode": run_decode,
                    "sync_page_table": sync_page_table,
                    "apply_page_copies": apply_page_copies}
        for n, fn in wrappers.items():
            setattr(self.ex, n, fn)
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.ex, n, fn)

    def count(self, kind: str) -> int:
        return sum(c[0] == kind for c in self.calls)

    def ms(self, kind: str) -> float | None:
        times = [c[1] for c in self.calls if c[0] == kind]
        return 1e3 * statistics.mean(times) if times else None

    def _plain_rows(self, eng):
        """The recorded calls again, in order, through the plain path on
        a fresh state, teacher-forced with the kernel path's inputs and
        page-table decisions.  Returns, per recorded call that produced
        logits, (kind, {row: the plain path's logits row})."""
        import torch
        orig, pair = self.orig, eng.program
        state = self.ex.init_program_state(pair, eng.device)
        rows = []
        for kind, _, args, got in self.calls:
            if kind == "table":
                state.caches[pair.page_table_region].copy_(
                    torch.from_numpy(args))
                continue
            if kind == "copies":
                orig["apply_page_copies"](state, pair, args)
                continue
            if kind == "prefill":
                tokens, slot, length, write_from = args
                out = orig["run_prefill"](pair.prefill, eng.params, tokens,
                                          state, slot, length, write_from,
                                          impl="reference")
                want = {0: out[0, length - 1]}
            elif kind == "chunk":
                tokens, slot, start, stop, length, write_from = args
                out = orig["run_prefill_chunk"](
                    pair.prefill, eng.params, tokens, state, slot, start,
                    stop, length, write_from, impl="reference")
                want = {i: out[i, length[i] - 1] for i in got}
            else:
                tokens, mask = args
                out = orig["run_decode"](pair.decode, eng.params, tokens,
                                         state, mask, impl="reference")
                want = {i: out[i] for i in got}
            rows.append((kind, {i: want[i].float().cpu().numpy()
                                for i in got}))
        return rows

    def replay_plain(self, eng, arch: str):
        """Every served logits row against the plain replay's, within the
        bound; the served token must equal the plain one wherever the
        plain top-2 gap exceeds twice the row's largest difference.

        For a recurrent family (``FAMILY_FLOOR``) the calls are replayed a
        second time with the recurrence as its sequential f32 oracle:
        the bound is then max(``LOGIT_TOL``, twice the largest difference
        between the two plain replays), for a model whose depth amplifies
        one-ulp differences past any fixed bound, and the mean |logit
        diff| over the rows must stay within ``FAMILY_MEAN_TOL``.
        Returns (max |logit diff|, rows compared, token ids compared,
        the two plain replays' largest difference or None, the bound) and
        prints the mean |logit diff| of each comparison."""
        import numpy as np
        plain = self._plain_rows(eng)
        spread, bound, note = None, LOGIT_TOL, ""
        if arch in FAMILY_FLOOR:
            with sequential_plain(*FAMILY_FLOOR[arch]):
                alt = self._plain_rows(eng)
            d = [np.abs(a[i] - b[i]) for (_, a), (_, b) in zip(plain, alt)
                 for i in a]
            spread = max(float(x.max()) for x in d)
            bound = max(LOGIT_TOL, 2 * spread)
            note = (f"; between the two plain replays "
                    f"{float(np.mean([x.mean() for x in d])):.4f}")
        served = [c for c in self.calls
                  if c[0] in ("prefill", "chunk", "decode")]
        worst, n_rows, n_ids, means = 0.0, 0, 0, []
        for (kind, want), (_, _, _, got) in zip(plain, served):
            for i, g in got.items():
                g, w = g.float().cpu().numpy(), want[i]
                means.append(float(np.abs(g - w).mean()))
                diff = float(np.abs(g - w).max())
                worst = max(worst, diff)
                n_rows += 1
                if not np.isfinite(g).all() or diff > bound:
                    fail(f"{kind}: served logits differ from the plain "
                         f"path by {diff:.3e} > {bound:.3e}")
                top2 = np.sort(w)[-2:]
                if top2[1] - top2[0] > 2 * diff:
                    n_ids += 1
                    if int(np.argmax(g)) != int(np.argmax(w)):
                        fail(f"{kind}: served token {int(np.argmax(g))} != "
                             f"plain {int(np.argmax(w))} with a top-2 gap "
                             f"of {top2[1] - top2[0]:.3f}")
        mean = float(np.mean(means))
        print(f"  mean |logit diff| per row: served against plain "
              f"{mean:.4f} (largest row {max(means):.4f}){note}")
        if arch in FAMILY_MEAN_TOL and mean > FAMILY_MEAN_TOL[arch]:
            fail(f"served logits differ from the plain path by {mean:.4f} "
                 f"per row on the mean > {FAMILY_MEAN_TOL[arch]}")
        return worst, n_rows, n_ids, spread, bound

    def prefill_tenures(self) -> list[tuple[int, int, int]]:
        """(slot, prompt length, chunk calls from its first chunk to its
        last) of every chunked prefill.  While any prefill is in flight
        the engine makes one chunk call per tick, so the count is the
        ticks from slot assignment to the first token."""
        first, out = {}, []
        chunks = [c[2] for c in self.calls if c[0] == "chunk"]
        for k, (_, slot, _, stop, length, _) in enumerate(chunks):
            for s, e, n in zip(slot.tolist(), stop.tolist(),
                               length.tolist()):
                first.setdefault(s, k)
                if e == n:
                    out.append((s, n, k - first.pop(s) + 1))
        return out


def lm_counters():
    from repro_torch.kernels.decode_attention.kernel import (
        decode_attention_cuda, paged_decode_attention_cuda)
    from repro_torch.kernels.flash_attention.bwd_kernel import (
        flash_attention_bwd_cuda)
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention_cuda)
    from repro_torch.kernels.mamba2.kernel import mamba2_scan_cuda
    from repro_torch.kernels.matmul.kernel import matmul_cuda
    from repro_torch.kernels.rwkv6.kernel import wkv6_cuda
    return {"flash_attention": flash_attention_cuda,
            "flash_attention_bwd": flash_attention_bwd_cuda,
            "decode_attention": decode_attention_cuda,
            "paged_decode_attention": paged_decode_attention_cuda,
            "matmul": matmul_cuda, "mamba2_scan": mamba2_scan_cuda,
            "wkv6": wkv6_cuda}


def serve_lm(label: str, run, n_requests: int, max_new: int = 32,
             arch: str = LM_ARCH):
    """Phases 5b-5e, 5g, 5h: one LM main path (``run()`` calls the
    serving entry point and returns its result), counters set to 0 just
    before it and read just after, under the Recorder; then the exact
    launch counts (``PAIR_OPS[arch]`` per call), every request served in
    full with no prefill recomputed, and the teacher-forced plain replay
    (``Recorder.replay_plain``).  Returns (launches, stats, engine,
    recorder)."""
    counters = lm_counters()
    for fn in counters.values():
        fn.launches = 0
    reset_matmul_paths()
    reset_flash_paths()
    with Recorder() as rec:
        res = run()
    launches = {k: fn.launches for k, fn in counters.items()}
    eng, done = res["engine"], res["done"]
    if len(done) != n_requests or not all(
            r.done and len(r.out_tokens) == max_new for r in done):
        fail(f"{label}: served {len(done)} of {n_requests} requests in full")
    if eng.n_prefill_recomputes or eng.n_prefills != n_requests:
        fail(f"{label}: prefills {eng.n_prefills}, recomputes "
             f"{eng.n_prefill_recomputes}")
    pre, dec = (Counter(op.kernel for op in prog.ops
                        if op.kernel in KERNEL_OPS)
                for prog in (eng.program.prefill, eng.program.decode))
    ticks = eng.n_decode_ticks
    passes = rec.count("prefill") + rec.count("chunk")
    paged = eng.program.paged is not None
    if rec.count("decode") != ticks:
        fail(f"{label}: {rec.count('decode')} decode calls, {ticks} ticks")
    want = {"flash_attention": passes * pre["flash_attention"],
            "flash_attention_bwd": 0,
            "decode_attention": 0 if paged else ticks * dec["decode_attention"],
            "paged_decode_attention": (ticks * dec["decode_attention"]
                                       if paged else 0),
            "matmul": passes * pre["matmul"] + ticks * dec["matmul"],
            "mamba2_scan": passes * pre["ssm_scan"] + ticks * dec["ssm_scan"],
            "wkv6": passes * pre["wkv"]}      # the decode step is plain
    print(f"{label}: {rec.count('prefill')} prefill calls, "
          f"{rec.count('chunk')} chunk calls, {ticks} decode ticks, kernel "
          f"ops per call {dict(pre)} / {dict(dec)}; launches {launches}, "
          f"want {want}")
    if (launches != want
            or (dict(pre), dict(dec)) != PAIR_OPS[arch]):
        fail(f"{label}: launch counts {launches} != {want}, or ops per "
             f"call not {PAIR_OPS[arch]}")
    # Decode ticks (M = slots) on skinny, admissions and chunks (M =
    # max_len rows per prompt) on wgmma.
    check_matmul_paths(label, ticks * dec["matmul"],
                       passes * pre["matmul"])
    # Every served flash call is bf16 on aligned views: the mma path.
    check_flash_paths(label, want["flash_attention"], 0)
    worst, n_rows, n_ids, spread, bound = rec.replay_plain(eng, arch)
    n_tok = sum(len(r.out_tokens) for r in done)
    stats = {"tok_s": n_tok / res["seconds"], "seconds": res["seconds"],
             "tokens": n_tok, "prefill_ms": rec.ms("prefill"),
             "chunk_ms": rec.ms("chunk"), "tick_ms": rec.ms("decode"),
             "prefills": rec.count("prefill"), "chunks": rec.count("chunk"),
             "ticks": ticks, "worst_logit_diff": worst,
             "plain_spread": spread, "logit_bound": bound}
    per_call = " ".join(f"{k} {stats[k + '_ms']:.2f} ms per call,"
                        for k in ("prefill", "chunk") if stats[k + "_ms"])
    floor_note = ("" if spread is None else
                  f" = max({LOGIT_TOL}, 2 x {spread:.3e}, the largest "
                  f"difference between two plain replays)")
    print(f"{label}: {n_rows} logits rows within {worst:.3e} of the plain "
          f"path (bound {bound:.3e}{floor_note}); {n_ids} token ids "
          f"compared, all "
          f"equal; {stats['tok_s']:.1f} tok/s ({n_tok} tokens in "
          f"{res['seconds']:.3f} s); {per_call} decode tick "
          f"{stats['tick_ms']:.2f} ms mean", flush=True)
    return launches, stats, eng, rec


def serve_paged(label: str):
    """Phases 5c-5e on the paged plan, each with its own requirement on
    the engine's page, admission and chunk counters."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    n = int(LM_ARGS[LM_ARGS.index("--requests") + 1])
    if label == "5d int8":
        run = lambda: serve.serve_lm(
            get_config(LM_ARCH), slots=SLOTS, max_len=LM_MAX_LEN,
            requests=n, max_new=32, seed=SEED, **PAGED_5D)
    else:
        run = lambda: serve.main(LM_ARGS + PAGED_RUNS[label])
    if label == "5e chunked":
        n += 1                                  # the long prompt
    launches, stats, eng, rec = serve_lm(label, run, n)
    adm = eng.admission
    stats.update(shared_pages=eng.n_shared_pages, cow_forks=eng.n_cow_forks,
                 requeued=adm.n_requeued,
                 pages_exhausted=adm.blocked["pages_exhausted"],
                 starved_ticks=eng.n_starved_ticks,
                 prefill_chunks=eng.n_prefill_chunks)
    print(f"{label}: shared_pages={eng.n_shared_pages} "
          f"cow_forks={eng.n_cow_forks} requeued={adm.n_requeued} "
          f"blocked={dict(adm.blocked)} prefill_chunks="
          f"{eng.n_prefill_chunks} starved_ticks={eng.n_starved_ticks}")
    if not (eng.n_shared_pages > 0 and eng.n_cow_forks > 0):
        fail(f"{label}: no shared pages or no COW fork")
    if label == "5d int8" and not (adm.n_requeued > 0 and
                                   adm.blocked["pages_exhausted"] > 0):
        fail(f"{label}: the pool never ran out at admission")
    if label == "5e chunked":
        tenures = rec.prefill_tenures()
        late = [t for t in tenures if t[2] > -(-t[1] // eng.chunk_size)]
        print(f"{label}: {len(tenures)} chunked prefills, ticks from slot "
              f"assignment to first token (slot, length, ticks): "
              f"{tenures}")
        if eng.n_starved_ticks or late or len(tenures) != n:
            fail(f"{label}: starved ticks {eng.n_starved_ticks}, prefills "
                 f"past ceil(length / {eng.chunk_size}) ticks: {late}")
    return launches, stats


@contextlib.contextmanager
def sequential_plain(module: str, fn: str):
    """Inside, the plain path of ``repro_torch.models.<module>`` runs its
    recurrence ``fn`` as the sequential f32 oracle (``impl="sequential"``)
    instead of the chunked form: a second plain version that sums in
    another order."""
    import importlib
    mod = importlib.import_module(f"repro_torch.models.{module}")
    orig = getattr(mod, fn)

    def swapped(*args, impl="auto", **kw):
        return orig(*args, impl="sequential" if impl == "reference" else impl,
                    **kw)
    setattr(mod, fn, swapped)
    try:
        yield
    finally:
        setattr(mod, fn, orig)


def _held(got, want, what: str, errs: dict, kernel: str,
          block: bool = False) -> None:
    """``got`` against ``want``: bf16 at atol = rtol = 2^-7 (phase 4's
    rule), f32 at 1e-4; a recurrent block's output (``block``) at 2^-7 of
    its largest magnitude.  That block composes its kernel's y (within
    the bf16 rule of the plain version) with a gated norm, a d_inner-wide
    projection and the residual add, plain torch on both sides, so a
    one-ulp difference in y reaches an output element through thousands
    of terms and may move a small one by more than its own ulps.  The
    largest |err| is kept per kernel in ``errs``."""
    import torch
    tol = BF16_TOL if want.dtype == torch.bfloat16 else TOL
    if block:
        got, want = got.float(), want.float()
        err, top = (got - want).abs().max().item(), want.abs().max().item()
        if not torch.isfinite(got).all() or err > tol * top:
            fail(f"{what}: the block's output differs from the plain "
                 f"path's by {err:.3e} > 2^-7 x its largest magnitude "
                 f"{top:.3e}")
    else:
        try:
            err = max_err(got, want, tol)
        except SystemExit as e:
            fail(f"{what}: {str(e).removeprefix('chip_smoke: FAIL: ')}")
    errs[kernel] = max(errs.get(kernel, 0.0), err)


def check_family_ops(label: str, eng, rec, arch: str) -> None:
    """Phases 5g and 5h, op by op: every admission the engine made before
    its first decode tick, then that tick, replayed from the recorded
    calls.  Each op whose kernel the kernel path launches (matmul,
    attention, the coarse recurrent block) runs once through the kernel
    path and once through the plain path on the plain path's input, and
    the two outputs are held to each other (``_held``); so are the
    recurrent states each block writes (the kernel side into copies of
    the regions it reads), live slots only at a tick.  The plain path's
    output and state go on to the next op.  The recurrence's plain
    version is its sequential f32 oracle, the function its kernel
    computes (the chunked form rounds its decay tile to bf16)."""
    import torch
    ex, pair, params = rec.ex, eng.program, eng.params
    state = ex.init_program_state(pair, eng.device)
    errs, n_ops = {}, Counter()

    def family(op, src, where, **kw):
        mine = {r: state.caches[r].clone() for r in op.state_regions}
        got = ex._run_family_op(op, src, params, mine, impl="cuda", **kw)
        out = ex._run_family_op(op, src, params, state.caches,
                                impl="reference", **kw)
        for r in op.state_regions:
            rows = (kw["slot"] if "slot" in kw
                    else kw["live"].nonzero().flatten())
            _held(mine[r][rows], state.caches[r][rows],
                  f"{where} {op.name} state {r}", errs, op.kernel)
        return got, out

    n_adm = 0
    with sequential_plain(*FAMILY_FLOOR[arch]):
        for kind, _, args, _ in rec.calls:
            if kind == "prefill":
                tokens, slot, length, _ = args
                prog, where = pair.prefill, f"admission (slot {slot})"
                rows = slice(None)
                n_adm += 1
            else:
                tokens, mask = args
                prog, where = pair.decode, "first tick"
                pos = state.lengths
                rows = live = mask.to(device=pos.device, dtype=torch.bool)
            regions = {prog.input_region: tokens}
            for op in prog.ops:
                src = regions[op.in_region]
                if op.kernel in ex._FAMILY_KERNELS:
                    kw = (dict(slot=slot, length=length) if kind == "prefill"
                          else dict(live=live))
                    got, out = family(op, src, where, **kw)
                elif op.kernel == "flash_attention":
                    got = ex._run_attention(op, regions, impl="cuda")
                    out, k, v = ex._run_attention(
                        op, regions, impl="reference", return_kv=True)
                    ex._write_prefill_cache(state.caches, op, k, v, slot,
                                            length)
                elif op.kernel == "decode_attention":
                    ck = state.caches[op.k_cache_region]
                    cv = state.caches[op.v_cache_region]
                    kv = (src, regions[op.k_region], regions[op.v_region])
                    got = ex._run_decode_attention(
                        op, *kv, ck.clone(), cv.clone(), pos, live,
                        impl="cuda")
                    out = ex._run_decode_attention(op, *kv, ck, cv, pos,
                                                   live, impl="reference")
                elif op.kernel in KERNEL_OPS:
                    got = ex._run_op(op, src, regions, params, impl="cuda")
                    out = ex._run_op(op, src, regions, params,
                                     impl="reference")
                else:
                    got = out = ex._run_op(op, src, regions, params,
                                           impl="reference")
                if op.kernel in KERNEL_OPS:
                    _held(got[rows], out[rows], f"{where} {op.name}", errs,
                          op.kernel, op.kernel in ex._FAMILY_KERNELS)
                    n_ops[op.kernel] += 1
                regions[op.out_region] = out
            if kind != "prefill":
                break
            state.lengths[slot] = length
        else:
            fail(f"{label}: no decode tick recorded to check op by op")
    print(f"{label}: every kernel op of {n_adm} admissions and the first "
          f"tick held to its plain version on the same input (bf16 "
          f"2^-7, a block's output 2^-7 of its largest magnitude, f32 "
          f"states 1e-4): ops {dict(n_ops)}; max |err| "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)


def serve_family(label: str, arch: str):
    """Phases 5g and 5h: ``repro_torch.launch.serve --arch <arch>`` at full
    width and depth in bf16 (random weights from the seed), 8 slots,
    max_len 512, 8 prompts of 32-448 tokens, 32 new tokens each, through
    ``serve_lm``'s launch, completion and replay checks.  Frees the
    engine's weights and state before returning (launches, stats)."""
    import gc
    import torch
    from repro_torch.launch import serve
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n = int(FAMILY_ARGS[FAMILY_ARGS.index("--requests") + 1])
    launches, stats, eng, rec = serve_lm(
        label, lambda: serve.main(["--arch", arch] + FAMILY_ARGS), n,
        arch=arch)
    check_family_ops(label, eng, rec, arch)
    pair = eng.program
    state_mb = {}
    for r in pair.decode.plan.persistent_regions():
        kind = r.name.split(".")[-1]
        state_mb[kind] = state_mb.get(kind, 0.0) + r.size_bytes / 1e6
    n_params = sum(t.numel() for t in _named_leaves(eng.params).values())
    stats.update(state_mb=state_mb, n_params=n_params,
                 peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"{label}: {n_params / 1e9:.3f} B parameters, persistent state "
          f"{pair.persistent_bytes / 1e6:.2f} MB (" + ", ".join(
              f"{k} {v:.2f} MB" for k, v in state_mb.items())
          + f"), peak memory allocated {stats['peak_gb']:.2f} GB",
          flush=True)
    del eng, rec, pair
    gc.collect()
    torch.cuda.empty_cache()
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
        kernel = ""
        for line in log.splitlines():
            if "entry function" in line:
                kernel = kernel_name(line)
            elif "registers" in line or "spill" in line:
                print(f"  {lib} {kernel}: {line.strip()}")

    rows = check_kernels(device, peaks)
    rows += check_bf16_convs(device)
    lm_rows, uses = check_lm_kernels(device, peaks)
    z_rows, z_uses = check_lm_kernels(device, peaks, "zamba2-7b")
    paged_rows = check_paged_kernel(device, peaks)
    ssm = check_ssm_kernels(device, peaks)
    bwd_row = check_flash_bwd(device, peaks)
    cnn_launches, img_s = serve_alexnet(device)
    resnet18_forward(device)
    from repro_torch.core import SNOWFLAKE
    pf_launches, pf_img_s, pf_tick_ms = serve_paper_faithful(device, img_s)
    n_strips = resnet18_forward(device, hw=SNOWFLAKE, paper_faithful=True)
    if n_strips != 20:
        fail(f"5i resnet18: {n_strips} strip launches, want 20")
    from repro_torch.launch import serve
    n_lm = int(LM_ARGS[LM_ARGS.index("--requests") + 1])
    lm_launches, lm_stats, _, _ = serve_lm(
        "5b", lambda: serve.main(LM_ARGS), n_lm)
    win_launches, win_stats, _, _ = serve_lm(
        "5b window", lambda: serve.main(LM_ARGS + ["--window",
                                                   str(LM_WINDOW)]), n_lm)
    paged = {label: serve_paged(label)
             for label in ("5c paged", "5d int8", "5e chunked")}
    smoke_launches = train_smoke(device)
    train_launches, train_stats = train_lm(device, bwd_row)
    family = {label: serve_family(label, arch) for label, arch in (
        ("5g zamba2-7b", "zamba2-7b"), ("5h rwkv6-7b", "rwkv6-7b"))}

    tick = {}
    for kname, label in (("conv2d_virtual", "alexnet-owt"),
                         ("matmul", "alexnet-owt"),
                         ("conv2d_strips", "alexnet-owt@snowflake"),
                         ("matmul@snowflake", "alexnet-owt@snowflake")):
        mine = [r for r in rows if r["kernel"] == kname.split("@")[0]
                and r["arch"] == label]
        keys = ("ms", "plain_ms", "library_ms", "bound_ms", "flop_ms",
                "byte_ms") + (("copy_ms",) if kname == "conv2d_strips"
                              else ())
        tick[kname] = {k: sum(r["uses"] * r[k] for r in mine) for k in keys}
        tick[kname]["launches"] = sum(r["uses"] for r in mine)
    ts, tm = tick["conv2d_strips"], tick["matmul@snowflake"]
    print(f"alexnet-owt SNOWFLAKE paper-faithful tick: served "
          f"{pf_tick_ms:.3f} ms against a device sum of "
          f"{ts['ms'] + ts['copy_ms'] + tm['ms']:.3f} ms (conv2d_strips "
          f"{ts['launches']} x = {ts['ms']:.4f} ms, bound "
          f"{ts['bound_ms']:.4f}, plain {ts['plain_ms']:.4f}, cuDNN "
          f"{ts['library_ms']:.4f}; strip copies {ts['copy_ms']:.4f} ms; "
          f"matmul {tm['launches']} x = {tm['ms']:.4f} ms); zero-copy "
          f"tick: conv2d_virtual {tick['conv2d_virtual']['ms']:.4f} ms")
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
    # The paged kernel per smollm-360m decode tick: one launch per layer
    # at phase 4's lengths, bf16 pools (the served type).
    n_layers = lm[("full", "decode", "decode_attention")]["launches"]
    paged_tick = {k: n_layers * paged_rows["bfloat16"][k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "flop_ms", "byte_ms")}
    paged_tick["launches"] = n_layers
    for label, (_, stats) in paged.items():
        print(f"smollm-360m {label}: {stats['tok_s']:.1f} tok/s, decode tick "
              f"{stats['tick_ms']:.3f} ms mean, prefill "
              f"{stats['prefill_ms'] or 0:.3f} ms, chunk "
              f"{stats['chunk_ms'] or 0:.3f} ms per call; paged kernel "
              f"{n_layers} x {paged_rows['bfloat16']['ms']:.4f} ms per tick "
              f"at phase 4's lengths (int8 pools "
              f"{paged_rows['int8']['ms']:.4f} ms)")
    print(f"alexnet-owt tick: matmul {tick['matmul']['ms']:.4f} ms "
          f"(3 launches)")
    # zamba2-7b per admission and per tick: the phase-4 rows of its
    # flash, decode and matmul ops and the scan at the served shapes.
    scan = ssm["mamba2_scan"]["rows"]
    n_scan = PAIR_OPS["zamba2-7b"][0]["ssm_scan"]
    n_wkv = PAIR_OPS["rwkv6-7b"][0]["wkv"]
    z = {}
    for kind, key in (("prefill", "admission"), ("decode", "tick")):
        parts = {k: lm_sums(z_rows, z_uses, "full", kind, k) for k in (
            "flash_attention", "decode_attention", "matmul")}
        parts["mamba2_scan"] = {k: n_scan * scan[key][k] for k in (
            "ms", "plain_ms", "bound_ms", "flop_ms", "byte_ms")}
        parts["mamba2_scan"]["launches"] = n_scan
        z[kind] = parts
        served = family["5g zamba2-7b"][1][
            "prefill_ms" if kind == "prefill" else "tick_ms"]
        print(f"zamba2-7b {kind}: served {served:.3f} ms per call against "
              f"a kernel sum of {sum(x['ms'] for x in parts.values()):.3f} "
              f"ms (bound {sum(x['bound_ms'] for x in parts.values()):.4f} "
              f"ms; " + ", ".join(
                  f"{k} {x['launches']} x = {x['ms']:.3f} ms"
                  for k, x in parts.items()) + "); cuBLAS in_proj / "
              "out_proj and the plain torch around them not timed per op")
    # The matmul kernel per Program run: the bf16 phase-4 rows summed over
    # smollm-360m's and zamba2-7b's admissions (M = 512, wgmma) and
    # decode ticks (M = 8, skinny), and the f32 phase-3 rows over one
    # alexnet-owt batch-8 tick (skinny).
    for what, t in (
            ("smollm-360m decode tick, bf16",
             lm[("full", "decode", "matmul")]),
            ("smollm-360m admission, bf16", lm[("full", "prefill", "matmul")]),
            ("zamba2-7b admission, bf16", z["prefill"]["matmul"]),
            ("zamba2-7b decode tick, bf16", z["decode"]["matmul"]),
            ("alexnet-owt tick, f32", tick["matmul"])):
        print(f"matmul per {what}: {t['launches']} launches, ms "
              f"{t['ms']:.4f}, library_ms {t['library_ms']:.4f}, bound_ms "
              f"{t['bound_ms']:.4f}, plain_ms {t['plain_ms']:.4f}")
    wkv = ssm["wkv6"]["rows"]["admission"]
    print(f"rwkv6-7b admission: served "
          f"{family['5h rwkv6-7b'][1]['prefill_ms']:.3f} ms, wkv6 {n_wkv} x "
          f"{wkv['ms']:.4f} = {n_wkv * wkv['ms']:.3f} ms (plain "
          f"{n_wkv * wkv['plain_ms']:.3f}, bound "
          f"{n_wkv * wkv['bound_ms']:.4f}); "
          f"decode tick {family['5h rwkv6-7b'][1]['tick_ms']:.3f} ms")

    per_path = [cnn_launches, pf_launches, lm_launches, win_launches,
                smoke_launches, train_launches] + [
        launch for launch, _ in list(paged.values()) + list(family.values())]
    launches = {k: sum(p.get(k, 0) for p in per_path) for k in SOURCES}
    errs = {k: max([r["max_abs_err"] for r in rows if r["kernel"] == k]
                   + [r["max_abs_err"] for r in lm_rows.values()
                      if r["kernel"] == k]
                   + ([r["max_abs_err"] for r in paged_rows.values()]
                      if k == "paged_decode_attention" else [])
                   + ([bwd_row["max_abs_err"]]
                      if k == "flash_attention_bwd" else [])
                   + [r["max_abs_err"] for r in z_rows.values()
                      if r["kernel"] == k]
                   + ([ssm[k]["max_abs_err"]] if k in ssm else []))
            for k in SOURCES}
    # The backward kernel per smollm-360m training step: one launch per
    # layer at the training shape, bf16.
    n_bwd = train_launches["flash_attention_bwd"] // TRAIN_STEPS
    train_step = {k: n_bwd * bwd_row[k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "flop_ms", "byte_ms")}
    train_step["launches"] = n_bwd
    # The flash kernels per Program run, from the bf16 phase-4 rows: the
    # forward per smollm-360m and zamba2-7b admission and per training
    # step (at batch 8 x 512, 2 launches a layer under remat), the
    # backward per training step.
    n_fwd = train_launches["flash_attention"] // TRAIN_STEPS
    fwd_step = {k: n_fwd * bwd_row["fwd_" + k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms")}
    fwd_step["launches"] = n_fwd
    for what, t in (
            ("forward per smollm-360m admission",
             lm[("full", "prefill", "flash_attention")]),
            ("forward per zamba2-7b admission",
             z["prefill"]["flash_attention"]),
            ("forward per smollm-360m training step", fwd_step),
            ("backward per smollm-360m training step", train_step)):
        print(f"flash {what}, bf16: {t['launches']} launches, ms "
              f"{t['ms']:.4f}, library_ms {t['library_ms']:.4f}, bound_ms "
              f"{t['bound_ms']:.4f}, plain_ms {t['plain_ms']:.4f}")
    per = {"conv2d_virtual": ("alexnet-owt batch-8 tick",
                              tick["conv2d_virtual"]),
           "conv2d_strips": (
               "SNOWFLAKE paper-faithful alexnet-owt batch-8 tick (5 "
               "launches; the strip copies' own device time, "
               f"{ts['copy_ms']:.4f} ms, is not in ms)", ts),
           "flash_attention": ("smollm-360m admission (prefill)",
                               lm[("full", "prefill", "flash_attention")]),
           "decode_attention": ("smollm-360m decode tick",
                                lm[("full", "decode", "decode_attention")]),
           "paged_decode_attention": (
               "smollm-360m paged decode tick, bf16 pools; library_ms is "
               "SDPA over the already-gathered view", paged_tick),
           "matmul": ("smollm-360m decode tick",
                      lm[("full", "decode", "matmul")]),
           "flash_attention_bwd": (
               f"smollm-360m training step ({n_bwd} launches at batch "
               f"{TRAIN_BATCH}, seq {TRAIN_SEQ}, bf16); library_ms is SDPA's "
               f"backward (forward + backward minus forward)", train_step),
           "mamba2_scan": (
               "zamba2-7b admission (81 launches at (1, 512, 112, 64), "
               "N = 64, bf16); no PyTorch call computes the scan, so "
               "library_ms is null", z["prefill"]["mamba2_scan"]),
           "wkv6": (
               "rwkv6-7b admission (32 launches at (1, 512, 64, 64), "
               "bf16); no PyTorch call computes the recurrence, so "
               "library_ms is null",
               {k: n_wkv * wkv[k] for k in ("ms", "plain_ms", "bound_ms",
                                            "flop_ms", "byte_ms")})}
    kernels = []
    for kname in ("conv2d_virtual", "conv2d_strips", "matmul",
                  "flash_attention",
                  "decode_attention", "paged_decode_attention",
                  "flash_attention_bwd", "mamba2_scan", "wkv6"):
        what, t = per[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": errs[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": ("operations" if t["flop_ms"] >= t["byte_ms"]
                         else "bytes"),
            "library_ms": t.get("library_ms")})
        print(f"kernels line: {kname} times per {what}")
        if launches[kname] == 0:
            fail(f"{kname} was never launched on the main paths")
    print(f"alexnet-owt serving: {img_s:.1f} img/s at {SLOTS} slots, "
          f"SNOWFLAKE paper-faithful {pf_img_s:.1f} img/s; "
          f"smollm-360m serving: {lm_stats['tok_s']:.1f} tok/s, window "
          f"{LM_WINDOW}: {win_stats['tok_s']:.1f} tok/s; "
          + ", ".join(f"{label}: {stats['tok_s']:.1f} tok/s"
                      for label, (_, stats) in paged.items())
          + f"; smollm-360m training: {train_stats['tok_s']:.0f} tokens/s, "
          f"step {train_stats['step_ms']:.1f} ms; "
          + ", ".join(f"{label}: {stats['tok_s']:.1f} tok/s"
                      for label, (_, stats) in family.items()))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
