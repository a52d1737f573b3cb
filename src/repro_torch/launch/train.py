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
tokens per second.  The multi-device ``--strategy`` of the reference is
ROADMAP A.12.
"""
from __future__ import annotations

import argparse
import logging
import os
import tempfile
import time

import torch

from ..configs import get_config
from ..configs.base import ShapeSpec
from ..data import PackedFileDataset, SyntheticLM
from ..kernels.common import resolve_device
from ..models import get_model, init_params
from ..optim import AdamW, cosine_schedule
from ..runtime import Trainer, TrainerConfig
from .steps import build_train_step


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
    step_fn = build_train_step(cfg, optimizer, impl="auto")
    params = init_params(get_model(cfg).param_defs(cfg),
                         torch.Generator(device).manual_seed(args.seed))
    opt_state = optimizer.init(params)
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
    params, opt_state, step = trainer.run(params, opt_state)
    seconds = time.perf_counter() - t0
    tokens = shape.global_batch * shape.seq_len
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
            "step": step, "trainer": trainer, "seconds": seconds}


if __name__ == "__main__":
    main()
