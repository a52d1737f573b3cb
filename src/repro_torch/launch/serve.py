"""Serving entry point: image classification off the compiled Program.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch alexnet-owt \
        --slots 8 --requests 16 [--device cpu]

CNN archs (alexnet-owt / resnet18 / resnet50) serve image-classify
requests through the compiled-Program path on the card (or, with
``--device cpu``, through the plain PyTorch versions on the CPU).
Weights are random, drawn from ``--seed``.  Prints the Program listing,
then ``served N images in T s (X img/s)``, then a few class ids.  An LM
arch exits 2: LM serving is not ported yet.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..configs import CNN_REGISTRY
from ..kernels.common import resolve_device
from ..models import cnn, init_params
from ..serving import Request, ServingEngine


def make_images(cfg, n: int, seed: int) -> list[np.ndarray]:
    """``n`` (H, W, C) float32 request images drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((cfg.input_hw, cfg.input_hw, cfg.input_ch))
            .astype(np.float32) for _ in range(n)]


def serve_cnn(arch: str, *, slots: int, requests: int, device=None,
              seed: int = 0) -> dict:
    """Serve ``requests`` random images of ``arch`` with random weights
    drawn from ``seed``; returns the engine, the finished requests (by
    uid) and the wall seconds of the serving loop."""
    cfg = CNN_REGISTRY[arch]
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = init_params(cnn.param_defs(cfg), gen, dev)
    eng = ServingEngine(cfg, params, slots=slots, device=dev)
    images = make_images(cfg, requests, seed)
    t0 = time.perf_counter()
    for i, img in enumerate(images):
        eng.submit(Request(uid=i, prompt=img))
    done = eng.run_until_drained()
    seconds = time.perf_counter() - t0
    return {"engine": eng, "done": sorted(done, key=lambda r: r.uid),
            "images": images, "seconds": seconds}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="alexnet-owt")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs "
                         "the plain PyTorch versions)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.arch not in CNN_REGISTRY:
        print(f"error: --arch {args.arch} is not yet ported to repro_torch "
              f"(ported: {', '.join(sorted(CNN_REGISTRY))})",
              file=sys.stderr)
        raise SystemExit(2)
    res = serve_cnn(args.arch, slots=args.slots, requests=args.requests,
                    device=args.device, seed=args.seed)
    done, dt = res["done"], res["seconds"]
    print(res["engine"].program.listing())
    print(f"served {len(done)} images in {dt:.2f}s "
          f"({len(done) / dt:.1f} img/s)")
    for r in done[:4]:
        print(f"  req {r.uid}: class {r.out_tokens[0]}")
    return res


if __name__ == "__main__":
    main()
