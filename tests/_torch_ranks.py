"""Run a script in a world of gloo ranks on the CPU, for the port's
multi-device tests.  Each rank is a fresh interpreter running
``script`` with ``RANK``, ``WORLD`` and ``STORE`` (a ``FileStore`` path
under the test's temporary directory: no TCP port, so parallel test
workers never race for one) and ``WORK`` (the directory the test and
the ranks exchange arrays through) in its globals, ``src`` on its path
and one torch thread.  The ranks import torch and ``repro_torch`` only.
Also ``split_train_counts``, the split train step's expected counters,
which the sharded and split tests both hold the ranks to.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = """
import os, sys
sys.path.insert(0, {src!r})
RANK, WORLD = int(sys.argv[1]), int(sys.argv[2])
STORE, WORK = sys.argv[3], sys.argv[4]
import torch
import torch.distributed as dist
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(STORE, WORLD),
                        rank=RANK, world_size=WORLD)
"""

EPILOGUE = """
dist.barrier()
dist.destroy_process_group()
"""


def run_ranks(script: str, work: str, world: int = 4,
              timeout: float = 240, meanwhile=None):
    """Run ``script`` on ``world`` ranks; returns each rank's output, or
    with ``meanwhile`` (called in this process while the ranks run) the
    outputs and what it returned.  Raises with the failing rank's output
    if any rank fails (the others are killed rather than left waiting
    in a collective)."""
    code = PRELUDE.format(src=os.path.join(ROOT, "src")) + script + EPILOGUE
    store = os.path.join(work, "store")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [os.path.join(work, f"rank{r}.log") for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, str(r), str(world), store,
                 work], stdout=f, stderr=subprocess.STDOUT, env=env))
    t0 = time.monotonic()
    try:
        extra = meanwhile() if meanwhile is not None else None
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or \
                    time.monotonic() - t0 > timeout:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outs = [open(f).read() for f in logs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n"
                               f"{out[-4000:]}")
    return outs if meanwhile is None else (outs, extra)


def split_train_counts(L, flash, *, remat=False, vocab=True, gathered=()):
    """A split train step's ``split.COUNTS`` with one cross-entropy chunk
    and L layers: each layer's flash launch, its 2 forward all-reduces
    (wo, w_down) and each gathered weight's gather; under remat the
    recompute again, up to the last tensor the backward needs
    (``torch.utils.checkpoint`` stops there): the flash launch, the
    gathers and wo's all-reduce, not w_down's; 2 backward all-reduces a
    layer (the attention and MLP inputs) and a reduce-scatter per
    gathered weight; with the vocab split, 1 forward all-reduce for the
    embedding, 3 for the chunk's cross-entropy (max, sum, gold logit)
    and 3 for its recompute, and 1 backward one for the head's input."""
    r = 2 if remat else 1
    out = {flash: r * L, "model_all_reduce:fwd": (1 + r) * L + 7 * vocab,
           "model_all_reduce:bwd": 2 * L + vocab}
    for n in gathered:
        out.update({f"model_gather:{n}": r * L,
                    f"model_reduce_scatter:{n}": L})
    return out
