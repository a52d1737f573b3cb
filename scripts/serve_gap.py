"""Where a sharded serving step's time goes beside the legacy path, on one
card: smollm-360m at full width and depth (bf16, a prefill of 8 x 512
and a decode step on its cache), NCCL as a world of one on a (1, 1)
("data", "model") mesh.

Three paths do the same computation: the legacy ``forward`` /
``decode_step``; ``build_step`` under tp (the split path, which at a
group of one gathers nothing); and under fsdp (the weight-gathered path:
every leaf gathered before a call, and in decode every cache leaf).
Each call is timed in turns with the others, ROUNDS rounds (medians);
the weight-gathered path's two gathers are timed alone; one call of each
is profiled for its device ms.  Outputs are held bit for bit by
``chip_smoke.py``'s phase 5t, not here.

    PYTHONPATH=src python3 scripts/serve_gap.py

Needs the card; builds the kernels first.  Prints one JSON line last.
"""
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

ROUNDS = 9


def main() -> int:
    import torch
    import torch.distributed as dist
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.hw import MeshDescriptor
    from repro_torch.kernels.common import build_kernels
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_mesh_from_descriptor
    from repro_torch.models import init_params, transformer
    from repro_torch.parallel import make_plan
    from repro_torch.parallel.placement import gather

    if not torch.cuda.is_available():
        print("serve_gap: no CUDA device", file=sys.stderr)
        return 1
    build_kernels()
    device = torch.device("cuda", 0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=device)
    desc = MeshDescriptor((1, 1), ("data", "model"))
    mesh = make_mesh_from_descriptor(desc, "cuda")
    cfg = get_config(cs.LM_ARCH)
    B, S = cs.TRAIN_BATCH, cs.TRAIN_SEQ
    full = init_params(transformer.param_defs(cfg),
                       torch.Generator(device).manual_seed(cs.SEED))
    head = full["embed"].T if cfg.tie_embeddings else full["lm_head"]
    gen = torch.Generator(device).manual_seed(cs.SEED + 5)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=device)
    tok = torch.randint(0, cfg.vocab, (B,), generator=gen, device=device)

    calls = {}
    with torch.no_grad():
        out = transformer.forward(full, toks, cfg, return_cache=True,
                                  return_hidden=True, cache_len=S)
        cache = out["cache"]
        calls["legacy prefill"] = lambda: transformer.forward(
            full, toks, cfg, return_cache=True, return_hidden=True,
            cache_len=S)["hidden"][:, -1] @ head
        calls["legacy decode"] = lambda: transformer.decode_step(
            full, cache, tok, cfg)
        for strategy in ("tp", "fsdp"):
            for kind in ("prefill", "decode"):
                shape = ShapeSpec(f"gap {kind}", S, B, kind)
                b = steps.build_step(cfg, shape,
                                     make_plan(cfg, shape, desc, strategy),
                                     mesh)
                p = steps.distribute_tree(full, b.specs["params"], mesh)
                if kind == "prefill":
                    calls[f"{strategy} prefill"] = (
                        lambda b=b, p=p: b.fn(p, {"tokens": toks}))
                    continue
                c = steps.distribute_tree(cache, b.specs["cache"], mesh)
                calls[f"{strategy} decode"] = (
                    lambda b=b, p=p, c=c: b.fn(p, c, {"tokens": tok}))
                if strategy == "fsdp":
                    calls["fsdp: every leaf gathered"] = (
                        lambda p=p: steps.gather_tree(p))
                    calls["fsdp: every cache leaf gathered"] = (
                        lambda c=c: {k: gather(v) for k, v in c.items()})

        def timed(call):
            torch.cuda.synchronize()
            t = time.perf_counter()
            call()
            torch.cuda.synchronize()
            return 1e3 * (time.perf_counter() - t)

        for call in calls.values():     # one-time costs, not timed
            call()
        ms = {k: [] for k in calls}
        for _ in range(ROUNDS):
            for k, call in calls.items():
                ms[k].append(timed(call))
        res = {}
        for k, call in calls.items():
            wall = statistics.median(ms[k])
            prof = cs.profile_train(f"serve_gap {k}", call, wall)
            res[k] = {"ms": wall, "device_ms": prof and prof["device_ms"],
                      "launches": prof and prof["launches"]}
    dist.destroy_process_group()
    print(f"serve_gap: ms, medians of {ROUNDS} in turns (device ms, one "
          "profiled call): " + "; ".join(
              f"{k} {v['ms']:.2f} ({v['device_ms']})"
              for k, v in res.items()))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
