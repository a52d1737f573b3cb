"""Serving entry point: requests served off the compiled Programs.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch alexnet-owt \
        --slots 8 --requests 16 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --slots 8 --max-len 512 --requests 16 --prompt-len 32-448 \
        --max-new 32 [--window 128] [--smoke --device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --slots 8 --max-len 512 --requests 16 --prompt-len 32-256 \
        --max-new 32 --paged --shared-prefix 256 [--kv-quant int8] \
        [--chunk-size 128 --long-prompt 448]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \
        --slots 8 --max-len 512 --requests 8 --prompt-len 32-448 \
        --max-new 32 [--smoke --device cpu]       # also mamba2, rwkv6-7b
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-1b-a400m --slots 8 --max-len 512 --requests 8 \
        --prompt-len 32-448 --max-new 32 [--smoke --device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \
        --slots 8 --max-len 448 --requests 16 --prompt-len 4-224 \
        --max-new 32 [--smoke --device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --slots 8 --max-len 512 --requests 16 --prompt-len 32-448 \
        --max-new 32 --spec-decode 4 [--draft smollm-360m] \
        [--chunk-size 128] [--metrics-out m.json --flight-out f.jsonl \
        --sample-ops 8 --dash-every 16]
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llama-3.2-vision-11b --slots 8 --max-len 512 --requests 8 \
        --prompt-len 4-32 --max-new 32 [--smoke --device cpu] [--program]

CNN archs (alexnet-owt / resnet18 / resnet50) serve image-classify
requests through the compiled Program; it prints the Program listing,
then ``served N images in T s (X img/s)`` and a few class ids.

LM archs -- dense (smollm-360m, llama3-8b, olmo-1b, deepseek-7b), MoE
(granite-moe-1b-a400m, llama4-maverick-400b-a17b), hybrid (zamba2-7b,
mamba2), ssm (rwkv6-7b) and audio (whisper-base) -- serve token requests
statefully through the compiled (prefill, decode) Program pair: each
request is prefilled once into the persistent regions (KV caches, or the
recurrent family's state), then every tick runs the decode Program.  An
audio request also carries stub encoder frames ((encoder_seq, d_model)
float32, drawn from ``--seed``; the audio frontend is a stub, as in the
reference), which admission encodes once into the slot's read-only
encoder memory.  The vlm (llama-3.2-vision-11b) has no Program
lowering: the engine warns once and serves it on the legacy decode loop
(``ServingEngine.fallback_reason``), its requests carrying no vision
input, as in the reference; ``--program`` makes that fallback an error:
the metrics and flight artifacts are written, ``error: --program
requested but <name> has no decode-Program lowering (<reason>)`` goes to
stderr and the exit code is 2.
``--smoke`` takes the reduced config, ``--window`` sets a sliding
attention window (the KV regions then hold ``min(max_len, window)``
rows), prompt lengths are drawn from ``--prompt-len LO-HI``.
``--paged`` serves off the paged KV plan (``--page-size`` rows per page,
``--kv-quant int8`` pages) with copy-on-write prefix sharing (dense and
MoE archs: recurrent state is not pageable; only dense archs are
chunkable, since MoE routing buckets the whole prompt);
``--shared-prefix N`` opens every prompt with the same N tokens, so
admission shares pages.  ``--chunk-size N`` prefills N prompt rows per
tick; ``--long-prompt N`` injects one prompt of N tokens two ticks into
the run.  ``--spec-decode K`` serves greedy speculative decode: a draft
pair proposes K tokens a slot per tick and the target verifies them in
one chunk call (dense archs, not paged, not windowed); ``--draft ARCH``
names the draft (same vocab, weights from ``--seed`` + 1; default: the
target itself).  It prints the pair's first listing line, ``served N
requests, T tokens in S s (X tok/s)``, the prefill / recompute /
decode-tick counters, the chunk, speculation, admission and page
counters where they apply (the listing line and the counters only on
the Program path), and a few streams.

The observability plane: ``--metrics-out PATH`` writes the metrics
registry's JSON snapshot to PATH and its Prometheus text to PATH.prom,
``--flight-out PATH`` the JSONL flight record (replay it with
``repro_torch.obs.replay_summary``), ``--sample-ops N`` times one decode
tick in N op by op (``op_time_us{kind}`` histograms, ``op_sample``
events) and ``--dash-every N`` prints a one-line dashboard every N
ticks.

Everything runs on the card unless ``--device cpu`` is given (the plain
PyTorch versions, eagerly).  On the card every Program run replays a
CUDA graph from its second call of a shape on (``runtime/executor.py``'s
graphed runners); the served seconds include the captures, and a line
``graph capture: S s`` gives their sum on its own.  Weights and
prompts are random, drawn from ``--seed``; ``--ckpt DIR`` loads the
params of the latest checkpoint in DIR instead (written by
``repro_torch.launch.train`` or by ``repro``'s trainer).  An unknown
architecture exits 2.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from ..checkpoint import restore_checkpoint
from ..configs import CNN_REGISTRY, get_config
from ..kernels.common import resolve_device
from ..models import cnn, get_model, init_params, param_defs
from ..obs import Observability
from ..serving import Request, ServingEngine


def make_images(cfg, n: int, seed: int) -> list[np.ndarray]:
    """``n`` (H, W, C) float32 request images drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((cfg.input_hw, cfg.input_hw, cfg.input_ch))
            .astype(np.float32) for _ in range(n)]


def make_prompts(vocab: int, n: int, lo: int, hi: int,
                 seed: int) -> list[np.ndarray]:
    """``n`` int32 prompts with lengths drawn from [lo, hi], from
    ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=rng.integers(lo, hi + 1))
            .astype(np.int32) for _ in range(n)]


def _restore_params(params, ckpt: str | None):
    """The params of the latest checkpoint in ``ckpt`` (a (params,
    opt_state) tree as the trainers of both packages save it), or
    ``params`` when ``ckpt`` is None."""
    if ckpt is None:
        return params
    (params, _), step = restore_checkpoint(ckpt, (params, {}))
    print(f"restored params from step {step}")
    return params


def drain(eng, dash_every: int = 0) -> list:
    """``eng.run_until_drained()``, printing ``eng.dashboard_line()``
    every ``dash_every`` ticks (0: never); the same 10,000-tick cap."""
    if not dash_every:
        return eng.run_until_drained()
    done = []
    for _ in range(0, 10_000, dash_every):
        ticks = eng.tick_no
        done += eng.run_until_drained(max_ticks=dash_every)
        if eng.tick_no - ticks < dash_every:
            break
        print(eng.dashboard_line())
    return done


def serve_cnn(arch: str, *, slots: int, requests: int, device=None,
              seed: int = 0, ckpt: str | None = None, program=None,
              obs: Observability | None = None,
              dash_every: int = 0) -> dict:
    """Serve ``requests`` random images of ``arch`` with random weights
    drawn from ``seed`` (or the params of the checkpoint in ``ckpt``),
    off ``program`` when one is given (a paper-faithful or SNOWFLAKE
    Program) or the engine's default Program, reporting through ``obs``;
    returns the engine, the finished requests (by uid), the images and
    the wall seconds of the serving loop."""
    cfg = CNN_REGISTRY[arch]
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = _restore_params(init_params(cnn.param_defs(cfg), gen, dev), ckpt)
    eng = ServingEngine(cfg, params, slots=slots, device=dev,
                        program=program, obs=obs)
    images = make_images(cfg, requests, seed)
    t0 = time.perf_counter()
    for i, img in enumerate(images):
        eng.submit(Request(uid=i, prompt=img))
    done = drain(eng, dash_every)
    seconds = time.perf_counter() - t0
    return {"engine": eng, "done": sorted(done, key=lambda r: r.uid),
            "images": images, "seconds": seconds}


def make_frames(cfg, n: int, seed: int) -> list[np.ndarray] | None:
    """``n`` (encoder_seq, d_model) float32 stub encoder inputs drawn
    from ``seed`` for a family whose requests carry one (audio), else
    None."""
    if get_model(cfg).encode_memory is None:
        return None
    rng = np.random.default_rng([seed, 2])
    return [rng.standard_normal((cfg.encoder_seq, cfg.d_model))
            .astype(np.float32) for _ in range(n)]


def serve_lm(cfg, *, slots: int, max_len: int, requests: int, max_new: int,
             prompt_len: tuple[int, int], device=None, seed: int = 0,
             shared_prefix: int = 0, long_prompt: int = 0,
             ckpt: str | None = None, draft_cfg=None, dash_every: int = 0,
             require_program: bool = False, **engine_kw) -> dict:
    """Serve ``requests`` random prompts of the LM ``cfg`` with
    random weights drawn from ``seed`` (or the params of the checkpoint
    in ``ckpt``); ``engine_kw`` (``paged``, ``page_size``,
    ``page_pool``, ``kv_quant``, ``chunk_size``, ``spec_k``, ``obs``)
    goes to the engine.  ``draft_cfg`` names a speculative draft, its
    weights drawn from ``seed + 1``.  With ``shared_prefix`` every prompt
    opens with the same tokens; ``long_prompt`` injects one prompt of
    that length after two ticks.  An audio request carries its stub
    encoder frames (``make_frames``).  Returns the engine, the finished
    requests (by uid), the prompts and the wall seconds of the serving
    loop (the kernels' first-use build and the weight init stay outside
    it); with ``require_program`` an engine that fell back to the legacy
    loop serves nothing ("done" None)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = _restore_params(
        init_params(param_defs(cfg), gen, dev), ckpt)
    if draft_cfg is not None:
        engine_kw.update(draft_cfg=draft_cfg, draft_params=init_params(
            param_defs(draft_cfg),
            torch.Generator(device=dev).manual_seed(seed + 1), dev))
    eng = ServingEngine(cfg, params, slots=slots, max_len=max_len,
                        device=dev, **engine_kw)
    if require_program and not eng.on_program_path:
        return {"engine": eng, "done": None, "prompts": None,
                "seconds": 0.0}
    prompts = make_prompts(cfg.vocab, requests, *prompt_len, seed)
    rng = np.random.default_rng([seed, 1])
    prefix = rng.integers(0, cfg.vocab, size=shared_prefix).astype(np.int32)
    prompts = [np.concatenate([prefix, p]) for p in prompts]
    if long_prompt:
        prompts.append(rng.integers(0, cfg.vocab, size=long_prompt)
                       .astype(np.int32))
    frames = make_frames(cfg, len(prompts), seed) or [None] * len(prompts)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i, prompt in enumerate(prompts[:requests]):
        eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=max_new,
                           extra=frames[i]))
    done = []
    if long_prompt:
        # Two ticks of steady decode, then the long prompt lands
        # mid-stream; with chunk_size its prefill interleaves with the
        # in-flight streams instead of stalling them.
        for _ in range(2):
            done += eng.step()
        eng.submit(Request(uid=requests, prompt=prompts[requests],
                           max_new_tokens=max_new, extra=frames[requests]))
    done += drain(eng, dash_every)
    seconds = time.perf_counter() - t0
    return {"engine": eng, "done": sorted(done, key=lambda r: r.uid),
            "prompts": prompts, "seconds": seconds}


def _write_artifacts(args, obs: Observability) -> None:
    """Close the flight recorder (flushing its file) and write the
    metrics registry: the JSON snapshot at ``--metrics-out`` and the
    Prometheus text beside it (``.prom``)."""
    obs.close()
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(obs.registry.to_json(arch=args.arch,
                                         argv=sys.argv[1:]))
        prom = args.metrics_out + ".prom"
        with open(prom, "w") as f:
            f.write(obs.registry.prometheus_text())
        print(f"metrics snapshot -> {args.metrics_out} (+ {prom})")
    if args.flight_out:
        print(f"flight record -> {args.flight_out}")


def _span(text: str) -> tuple[int, int]:
    lo, _, hi = text.partition("-")
    lo, hi = int(lo), int(hi or lo)
    if not 1 <= lo <= hi:
        raise argparse.ArgumentTypeError(f"want LO-HI with 1 <= LO <= HI, "
                                         f"got {text!r}")
    return lo, hi


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="alexnet-owt")
    ap.add_argument("--smoke", action="store_true",
                    help="the LM arch's reduced same-family config")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--program", action="store_true",
                    help="require the compiled Program path: an LM arch "
                         "with no Program lowering exits 2 instead of "
                         "serving on the legacy decode loop")
    ap.add_argument("--window", type=int, default=None,
                    help="sliding attention window (LM archs); the KV "
                         "regions then hold min(max_len, window) rows")
    ap.add_argument("--prompt-len", type=_span, default=(1, 7),
                    metavar="LO-HI", help="prompt lengths, drawn uniformly")
    ap.add_argument("--paged", action="store_true",
                    help="serve off the paged KV plan: page pools + a "
                         "per-slot page table, copy-on-write prefix "
                         "sharing (LM archs)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="rows per KV page (must divide --max-len)")
    ap.add_argument("--kv-quant", choices=["int8"], default=None,
                    help="int8 KV pages with per-page scales (--paged)")
    ap.add_argument("--shared-prefix", type=int, default=0, metavar="N",
                    help="open every prompt with the same N tokens "
                         "(paged prefix sharing)")
    ap.add_argument("--chunk-size", type=int, default=None, metavar="N",
                    help="chunked prefill: N prompt rows per tick")
    ap.add_argument("--long-prompt", type=int, default=0, metavar="N",
                    help="inject one prompt of N tokens two ticks into "
                         "the run")
    ap.add_argument("--spec-decode", type=int, default=0, metavar="K",
                    help="speculative decode: a draft pair proposes K "
                         "tokens a slot per tick, the target verifies "
                         "the bursts in one chunk call (greedy)")
    ap.add_argument("--draft", default=None, metavar="ARCH",
                    help="draft arch for --spec-decode (same vocab, "
                         "weights from --seed + 1; default: the target)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics registry's JSON snapshot to "
                         "PATH and its Prometheus text to PATH.prom")
    ap.add_argument("--flight-out", default=None, metavar="PATH",
                    help="record the JSONL flight record (per-request "
                         "lifecycle events and per-tick snapshots)")
    ap.add_argument("--sample-ops", type=int, default=0, metavar="N",
                    help="time one decode tick in N op by op "
                         "(op_time_us{kind} histograms); 0 = off")
    ap.add_argument("--dash-every", type=int, default=0, metavar="N",
                    help="print a one-line dashboard every N ticks; "
                         "0 = off")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs "
                         "the plain PyTorch versions)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint dir to load params from")
    args = ap.parse_args(argv)
    obs = Observability(flight_path=args.flight_out,
                        sample_ops_every=args.sample_ops)
    if args.arch in CNN_REGISTRY:
        res = serve_cnn(args.arch, slots=args.slots, requests=args.requests,
                        device=args.device, seed=args.seed, ckpt=args.ckpt,
                        obs=obs, dash_every=args.dash_every)
        done, dt = res["done"], res["seconds"]
        print(res["engine"].program.listing())
        print(f"served {len(done)} images in {dt:.2f}s "
              f"({len(done) / dt:.1f} img/s)")
        print(f"graph capture: {res['engine'].capture_seconds:.3f} s")
        for r in done[:4]:
            print(f"  req {r.uid}: class {r.out_tokens[0]}")
        _write_artifacts(args, obs)
        return res
    try:
        cfg = get_config(args.arch)
        draft_cfg = get_config(args.draft) if args.draft else None
    except KeyError as e:
        print(f"error: --arch {args.arch}: {e}", file=sys.stderr)
        raise SystemExit(2)
    if args.smoke:
        cfg = cfg.smoke()
        draft_cfg = draft_cfg and draft_cfg.smoke()
    if args.window:
        cfg = dataclasses.replace(cfg, attn_window=args.window)
    res = serve_lm(cfg, slots=args.slots, max_len=args.max_len,
                   requests=args.requests, max_new=args.max_new,
                   prompt_len=args.prompt_len, device=args.device,
                   seed=args.seed, shared_prefix=args.shared_prefix,
                   long_prompt=args.long_prompt, ckpt=args.ckpt,
                   draft_cfg=draft_cfg, dash_every=args.dash_every,
                   paged=args.paged, page_size=args.page_size,
                   kv_quant=args.kv_quant, chunk_size=args.chunk_size,
                   spec_k=args.spec_decode, obs=obs,
                   require_program=args.program)
    eng, done, dt = res["engine"], res["done"], res["seconds"]
    if done is None:
        # The program path was asked for: a legacy-loop run would
        # misreport what was measured.  The artifacts carry the
        # fallback event and gauge.
        _write_artifacts(args, obs)
        print(f"error: --program requested but {cfg.name} has no "
              f"decode-Program lowering ({eng.fallback_reason})",
              file=sys.stderr)
        raise SystemExit(2)
    n_tok = sum(len(r.out_tokens) for r in done)
    if eng.on_program_path:
        print(eng.program.listing().splitlines()[0])
    print(f"served {len(done)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s)")
    print(f"graph capture: {eng.capture_seconds:.3f} s")
    if eng.on_program_path:
        print(f"prefills={eng.n_prefills} "
              f"prefill_recomputes={eng.n_prefill_recomputes} "
              f"decode_ticks={eng.n_decode_ticks}")
    if eng.chunk_size is not None:
        print(f"prefill_chunks={eng.n_prefill_chunks} "
              f"starved_ticks={eng.n_starved_ticks}")
    if eng.spec_k:
        print(f"spec_proposed={eng.n_spec_proposed} "
              f"spec_accepted={eng.n_spec_accepted} "
              f"spec_rollbacks={eng.n_spec_rollbacks}")
    adm = getattr(eng, "admission", None)
    if adm is not None and (adm.n_rejected or adm.n_requeued):
        print(f"rejected={adm.n_rejected} requeued={adm.n_requeued} "
              f"last_blocked={adm.last_blocked}")
    if args.paged:
        print(f"shared_pages={eng.n_shared_pages} "
              f"cow_forks={eng.n_cow_forks} "
              f"pool_used={eng._pool.used_pages} "
              f"pool_free={eng._pool.free_pages}")
    for r in done[:4]:
        print(f"  req {r.uid}: {len(r.prompt)} prompt tokens -> "
              f"{r.out_tokens}")
    _write_artifacts(args, obs)
    return res


if __name__ == "__main__":
    main()
