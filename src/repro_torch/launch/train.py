"""Training driver (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch smollm-360m --smoke --steps 3 --device cpu

On the card (the default) every attention forward and backward runs the
hand-written CUDA flash kernels, every selective scan (zamba2, mamba2)
and WKV6 recurrence (rwkv6) the CUDA scan kernels, and the step runs
off a CUDA graph (``launch/steps.py``: step 0 eager, step 1 captured,
replays after); with ``--device cpu`` the plain PyTorch versions,
eagerly.  ``--arch`` takes the dense, MoE, hybrid and ssm configs.  An
MoE arch (``--arch granite-moe-1b-a400m``) adds the load-balance term
to the loss and prints each step's expert imbalance.  The vlm and
audio families are refused: their steps need ``vision_embeds`` /
``encoder_frames``, which the synthetic token stream does not carry
(nor does the reference's); train them through
``steps.build_train_step`` with the extra input in each batch.
Parameters are initialised from ``--seed``; the data is the seeded
``SyntheticLM`` stream or a packed token file.  Fault tolerance
(auto-resume from ``--ckpt-dir``, preemption checkpoint, straggler log)
comes from ``runtime.Trainer``.  Prints each step's loss, time and
tokens per second.

``--strategy {tp,fsdp,auto}`` trains through the sharded step
(``steps.build_step``) on a ``("data", "model")`` mesh of every rank,
shaped as the reference shapes it: ``(n // 2, 2)`` from 4 ranks up, else
``(n, 1)``; ``parallel.make_plan`` picks the layout.  A dense config
under ``tp`` or ``auto``'s ``mixed`` layout trains split over "model"
(each rank its blocks' columns, rows, heads and vocab, forward and
backward); ``fsdp``, ``flat_dp`` and the other families gather each
weight whole.  On the card it
initialises NCCL, from torchrun's environment when ``WORLD_SIZE`` is set
(one process per card: ``torchrun --nproc-per-node 4 -m
repro_torch.launch.train --strategy auto ...``), else as a world of one;
``--device cpu`` uses gloo.  A checkpoint gathers the full tensors and
rank 0 writes them; a resume redistributes them per the plan.  Without
``--strategy`` the CLI runs the graphed single-device step (the
reference always builds a mesh).
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time

import torch
import torch.distributed as dist

from ..configs import get_config
from ..configs.base import ShapeSpec
from ..data import PackedFileDataset, SyntheticLM
from ..kernels.common import resolve_device
from ..models import get_model, init_params
from ..optim import AdamW, cosine_schedule
from ..core.hw import MeshDescriptor
from ..parallel import STRATEGIES, make_plan
from ..runtime import Trainer, TrainerConfig
from .mesh import make_mesh_from_descriptor
from .steps import build_step, build_train_step, distribute_tree


def init_distributed(device: torch.device) -> torch.device:
    """Initialise ``torch.distributed`` for ``--strategy``: NCCL on the
    card (never gloo there), gloo on the CPU; from torchrun's
    environment when ``WORLD_SIZE`` is set, else a world of one.
    Returns this rank's device."""
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        torch.cuda.init()       # the mesh then keeps this device
        backend, kw = "nccl", {"device_id": device}
    else:
        backend, kw = "gloo", {}
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    return device


def mesh_descriptor(n: int) -> MeshDescriptor:
    """The reference's CLI mesh of ``n`` devices."""
    return MeshDescriptor((n // 2, 2) if n >= 4 else (n, 1),
                          ("data", "model"))


def main(argv=None) -> dict:
    """Run the CLI; returns the run's cfg, final params and optimizer
    state, step, trainer and wall seconds."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--opt-bits", type=int, default=32, choices=[8, 32])
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_train under the temp dir")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--data", default="synthetic",
                    help="'synthetic' or a packed-token file path")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the plain path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--strategy", default=None, choices=STRATEGIES,
                    help="train the sharded step on a mesh of every rank "
                         "(a dense config split over 'model' under tp and "
                         "auto's mixed layout, else weight-gathered); "
                         "default: the graphed single-device step")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    extra = get_model(cfg).extra_input
    if extra:
        raise ValueError(
            f"{cfg.name}: the {cfg.family} family's step needs {extra}, "
            f"which the synthetic token stream does not carry; train it "
            f"through launch.steps.build_train_step with {extra} in each "
            f"batch")
    shape = ShapeSpec("cli_train", args.seq, args.batch, "train")
    optimizer = AdamW(lr=cosine_schedule(args.lr, warmup=20,
                                         total=args.steps),
                      state_bits=args.opt_bits)
    owns_group = False
    if args.strategy and not dist.is_initialized():
        device, owns_group = init_distributed(device), True
    params = init_params(get_model(cfg).param_defs(cfg),
                         torch.Generator(device).manual_seed(args.seed))
    opt_state = optimizer.init(params)
    mesh = plan = None
    if args.strategy:
        desc = mesh_descriptor(dist.get_world_size())
        mesh = make_mesh_from_descriptor(desc, device.type)
        plan = make_plan(cfg, shape, desc, args.strategy)
        bundle = build_step(cfg, shape, plan, mesh, optimizer=optimizer,
                            impl="auto")
        params = distribute_tree(params, bundle.specs["params"], mesh)
        opt_state = distribute_tree(opt_state, bundle.specs["opt_state"],
                                    mesh)
        step_fn = bundle.fn
    else:
        step_fn = build_train_step(cfg, optimizer, impl="auto")
    if args.data == "synthetic":
        data = SyntheticLM(vocab=cfg.vocab, seq_len=shape.seq_len,
                           global_batch=shape.global_batch, seed=0)
    else:
        data = PackedFileDataset(args.data, cfg.vocab, shape.seq_len,
                                 shape.global_batch)
    ckpt_dir = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                             "repro_torch_train")
    trainer = Trainer(step_fn, data, TrainerConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=ckpt_dir, log_every=1), device=device)
    t0 = time.perf_counter()
    try:
        params, opt_state, step = trainer.run(params, opt_state)
    finally:
        if owns_group:
            dist.destroy_process_group()
    seconds = time.perf_counter() - t0
    tokens = shape.global_batch * shape.seq_len
    if plan is not None:
        print(f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}, "
              f"strategy {plan.strategy}, layout "
              f"{plan.decisions.get('layout', plan.strategy)}")
    for rec in trainer.metrics_history:
        moe = (f", moe imbalance {rec['moe_imbalance_pct']:.1f}%"
               if "moe_imbalance_pct" in rec else "")
        print(f"step {rec['step']}: loss {rec['loss']:.4f}, "
              f"{1e3 * rec['dt_s']:.1f} ms, "
              f"{tokens / rec['dt_s']:.0f} tokens/s{moe}")
    print(f"finished at step {step}; " + (
        f"last loss {trainer.metrics_history[-1]['loss']:.4f}"
        if trainer.metrics_history else "no steps ran"))
    return {"cfg": cfg, "params": params, "opt_state": opt_state,
            "step": step, "trainer": trainer, "seconds": seconds,
            "mesh": mesh, "plan": plan}


if __name__ == "__main__":
    main()
