"""Multi-pod dry-run: count every (arch x shape x mesh) cell's sharded step
on a fake world of 512 ranks (counterpart of ``repro/launch/dryrun.py``).

    python -m repro_torch.launch.dryrun [--arch A] [--shape S] \\
        [--mesh single|multi|both] [--strategy auto] [--out F.jsonl]

This entry point runs on the CPU by design, the one in the port that
does not default to the card: like the reference's, which compiles for
512 forced host devices, it needs no accelerator.  For each cell it

  1. initialises a fake process group of 512 ranks once per process
     (``torch.distributed``'s "fake" backend: every collective returns at
     once and moves nothing), this process rank 0;
  2. builds the production mesh over its first 256 ranks (16x16) or all
     512 (2x16x16) and the sharded step of ``launch/steps.py`` with
     ``impl="reference"`` (the port's CUDA kernels are invisible to the
     counters, as Mosaic is unavailable to the reference off-TPU);
  3. inside ``FakeTensorMode`` (no storage is allocated) makes the
     parameters, optimizer state, batch and cache the spec functions
     describe and places them under the plan's specs
     (``distribute_tree``);
  4. runs the step once under ``core/step_analysis.py::analyze_step``:
     FLOPs, HBM bytes, collective link bytes and memory, per rank;
  5. appends one JSON record per cell, with the reference's keys, so one
     ``launch/report.py`` renders either package's file: ``compile_s``
     holds the traced seconds, ``hlo_flops`` / ``hlo_bytes`` /
     ``coll_link_bytes_per_chip`` the counted step's numbers.

What differs from the reference's counts: the step runs eagerly (every
op's bytes, no fusion).  The dense family's train, prefill and decode
steps run split over "model" as the reference's do
(``parallel/split.py``), but for the K / V projections of a KV head
shared by several "model" ranks and the attention of a head count
"model" does not divide, which each such rank computes (forward and
backward); every other step is weight-gathered, so each rank holds
every gathered leaf (``temp_size_in_bytes``) and its ``tp`` / ``mixed``
classes and MoE's experts count their compute once per "model" rank,
as the sequence-parallel prefill's classes do (ROADMAP A.12 c).  Importing this module
touches no process group; ``run_cell`` and ``main`` do.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import REGISTRY, get_config
from ..core.hw import TPU_V5E
from ..core.roofline import roofline_report
from ..core.step_analysis import MEMORY_FIELDS, analyze_step
from ..models import abstract_params, get_model
from ..optim import AdamW
from ..parallel.rules import make_plan
from .mesh import descriptor_for, make_mesh_from_descriptor
from .steps import abstract_cache, build_step, distribute_tree, input_specs

__all__ = ["F8_DECODE_ARCHS", "WORLD", "analytic_flops", "fake_world",
           "count_step", "cell_record", "run_cell", "main"]

# Serving-memory adaptations per cell (the reference's): fp8 KV caches
# for the large dense/MoE decode cells.
F8_DECODE_ARCHS = {"llama3-8b", "deepseek-7b", "olmo-1b",
                   "llama4-maverick-400b-a17b", "llama-3.2-vision-11b"}
WORLD = 512


def analytic_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N·D for inference steps."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch          # one token per sequence


def fake_world(world: int = WORLD) -> None:
    """Initialise a fake process group of ``world`` ranks, this process
    rank 0, unless one of at least that size is up."""
    if dist.is_initialized():
        if dist.get_world_size() < world:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is up; the dry-run needs {world}")
        return
    # Importing the module registers the "fake" backend.
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _fake(tree):
    """A fake CPU tensor for every ``meta`` leaf of a tree of dicts."""
    if isinstance(tree, dict):
        return {k: _fake(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype)


def count_step(cfg, shape, plan, mesh, *, optimizer=None):
    """(plan's step bundle, ``StepStats``): the sharded step of one cell
    built with ``impl="reference"`` and run once under ``analyze_step``
    on fake operands placed under its specs.  ``mesh`` lies on the
    initialised (usually fake) process group."""
    optimizer = optimizer or AdamW()
    bundle = build_step(cfg, shape, plan, mesh, optimizer=optimizer,
                        impl="reference")
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        full = _fake(abstract_params(get_model(cfg).param_defs(cfg)))
        params = distribute_tree(full, bundle.specs["params"], mesh)
        batch = _fake(input_specs(cfg, shape))
        if shape.kind == "train":
            state = distribute_tree(optimizer.init(full),
                                    bundle.specs["opt_state"], mesh)
            args = (params, state, batch)
        elif shape.kind == "prefill":
            args = (params, batch)
        else:
            cache = _fake(abstract_cache(cfg, shape.global_batch,
                                         shape.seq_len))
            args = (params, distribute_tree(cache, bundle.specs["cache"],
                                            mesh), batch)
        del full
        stats = analyze_step(bundle.fn, *args, n_chips=mesh.size())
    return bundle, stats


def cell_record(cfg, shape, plan, mesh, *, arch: str, mesh_name: str,
                optimizer=None, hw=TPU_V5E) -> dict:
    """One cell's record, with the reference's keys: ``plan``'s step on
    ``mesh`` counted by ``count_step`` and its roofline on ``hw``."""
    n_chips = mesh.size()
    t0 = time.time()
    _, st = count_step(cfg, shape, plan, mesh, optimizer=optimizer)
    t_trace = time.time() - t0

    rep = roofline_report(
        arch=arch, shape=shape.name, mesh_name=mesh_name,
        n_chips=n_chips, stats=st,
        model_flops=analytic_flops(cfg, shape), hw=hw,
        analytic_flops=analytic_flops(cfg, shape))
    return {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "strategy": plan.strategy, "kind": shape.kind,
        "chips": n_chips,
        "compile_s": round(t_trace, 1),
        "memory_analysis": {f: st.memory.get(f) for f in MEMORY_FIELDS},
        "hlo_flops": rep.hlo_flops, "hlo_bytes": rep.hlo_bytes,
        "coll_link_bytes_per_chip": rep.coll_link_bytes,
        "coll_counts": rep.coll_counts,
        "compute_ms": rep.compute_s * 1e3,
        "memory_ms": rep.memory_s * 1e3,
        "collective_ms": rep.collective_s * 1e3,
        "dominant": rep.dominant,
        "model_flops": rep.model_flops,
        "useful_ratio": rep.useful_ratio,
        "notes": rep.notes,
        "decisions": plan.decisions,
    }


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             strategy: str = "auto", optimizer_bits: int = 32,
             hw=TPU_V5E) -> dict:
    cfg = get_config(arch)
    shape = {s.name: s for s in cfg.shapes()}[shape_name]
    if shape.kind == "decode" and arch in F8_DECODE_ARCHS:
        cfg = dataclasses.replace(cfg, kv_dtype="float8")
    desc = descriptor_for(multi_pod=multi_pod)
    fake_world()
    return cell_record(cfg, shape, make_plan(cfg, shape, desc, strategy),
                       make_mesh_from_descriptor(desc, "cpu"), arch=arch,
                       mesh_name="2x16x16" if multi_pod else "16x16",
                       optimizer=AdamW(state_bits=optimizer_bits), hw=hw)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--strategy", default="auto")
    ap.add_argument("--optimizer-bits", type=int, default=32)
    ap.add_argument("--out", default="dryrun_results.jsonl")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = list(REGISTRY) if args.arch == "all" else [args.arch]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    done = set()
    if args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    done.add((r["arch"], r["shape"], r["mesh"],
                              r.get("strategy", "auto")))
                except Exception:
                    pass

    with open(args.out, "a") as out:
        for arch in archs:
            cfg = get_config(arch)
            shapes = ([s.name for s in cfg.shapes()]
                      if args.shape == "all" else [args.shape])
            for shape_name in shapes:
                for multi in meshes:
                    mesh_name = "2x16x16" if multi else "16x16"
                    key = (arch, shape_name, mesh_name, args.strategy)
                    if key in done:
                        continue
                    # big MoE training: 8-bit optimizer states to fit
                    bits = args.optimizer_bits
                    if (arch == "llama4-maverick-400b-a17b"
                            and shape_name == "train_4k"):
                        bits = 8
                    tag = f"{arch} x {shape_name} x {mesh_name}"
                    print(f"=== {tag}", flush=True)
                    try:
                        rec = run_cell(arch, shape_name, multi_pod=multi,
                                       strategy=args.strategy,
                                       optimizer_bits=bits)
                        print(f"    ok traced={rec['compile_s']}s "
                              f"dominant={rec['dominant']} "
                              f"GFLOPs/chip="
                              f"{rec['hlo_flops'] / rec['chips'] / 1e9:.1f} "
                              f"coll={rec['coll_link_bytes_per_chip'] / 1e6:.0f}"
                              f"MB/chip", flush=True)
                        print(f"    memory_analysis={rec['memory_analysis']}",
                              flush=True)
                    except Exception as e:
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": mesh_name, "strategy": args.strategy,
                               "error": f"{type(e).__name__}: {e}",
                               "traceback": traceback.format_exc()[-2000:]}
                        print(f"    FAILED: {type(e).__name__}: {e}",
                              flush=True)
                    out.write(json.dumps(rec) + "\n")
                    out.flush()
        # record the spec-mandated skips
        for arch in archs:
            cfg = get_config(arch)
            for sk in cfg.skipped_shapes():
                out.write(json.dumps({
                    "arch": arch, "shape": sk, "skipped": True,
                    "reason": "pure full-attention arch; long_500k "
                              "requires sub-quadratic mixing "
                              "(DESIGN.md §4)"}) + "\n")


if __name__ == "__main__":
    main()
