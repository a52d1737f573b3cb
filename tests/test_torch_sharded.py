"""The port's sharded train / prefill / decode steps
(``launch/steps.py::build_step``) across 4 gloo ranks, on a (2, 2)
("data", "model"), a (2, 1, 2) ("pod", "data", "model") and a (1, 4)
("data", "model") mesh, held to ``repro``'s single-device functions
(f32, within 1e-5).

The oracle: with equal batch blocks, the global mean cross-entropy plus
``AUX_LOSS_WEIGHT`` times the layer mean of the block-mean load-balance
loss is the mean over the blocks of each block's single-device loss.
So the step's loss and gradients must equal ``repro``'s single-device
loss and gradients on each block, averaged (MoE on its manual path:
one block per ("pod", "data") shard; on its global path: one block of
every row), and the parameters and moments after the update must equal
``repro``'s single-device AdamW update applied to the step's gradients
(8-bit moments: the row scales within 1e-5, each int8 value on the same
step of the grid or the next).
Prefill and decode logits and caches must equal ``repro``'s legacy
forward and decode step on the same rows.  Every parameter and moment
leaf must be a DTensor under its spec's placements.  The dense family's
train, prefill and decode steps under tp and auto run split over "model"
(``parallel/split.py``): every rank writes the split's counters of each
such case (``split.COUNTS``: the head case and head counts of its flash
and decode launches, the weights gathered over "model", the cache
exchanges; in training the forward and backward all-reduces and the
gathers' reduce-scatters), and they must be the case's expected ones,
with no whole cache leaf gathered but where the cache spec spreads the
KV heads over ("data", "model") (one sequence on (2, 2): every rank runs
it); every other family and fsdp run weight-gathered, with no split
counted.

Cases: smollm-360m smoke under tp, fsdp and auto on both meshes, with
8-bit moments under tp (the row scale over a sharded last axis);
granite-moe-1b-a400m smoke at 8 x 64 (256 tokens a data shard: the
manual path; also under fsdp, where a block spans two ranks) and at
2 x 64 (the global path); one train step each of zamba2-7b, rwkv6-7b
and whisper-base smoke on (2, 2); on (1, 4), a prefill and 2 decode steps
on its cache of smollm-360m smoke (4 / 2 heads: each KV head shared by
2 ranks, the cache split over head_dim, a vocab-parallel head) and of
olmo-1b smoke (4 / 4: whole heads and cache blocks) under tp and auto,
of smollm-360m smoke with 6 / 2 heads under tp (a block would cut a
head: the attention weights gathered over "model", a whole cache layer
gathered in decode), and of olmo-1b smoke with one sequence on (2, 2)
under tp; on (1, 4), a train step of each of those three head cases
under tp, and on (2, 2) one of smollm-360m smoke under auto at batch 2
(wk / wv kept whole along "model" and cut locally); and on (1, 4) the
6 / 2 heads under tp with wo kept whole along "model" (``KEEP_WHOLE``),
a train step and a prefill with 2 decode steps (wo cut locally in the
cut case, its gradient summed over "model").  One world of ranks
runs them all."""
import dataclasses
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import REGISTRY as JREGISTRY  # noqa: E402
from repro.launch.steps import AUX_LOSS_WEIGHT  # noqa: E402
from repro.launch.steps import abstract_cache as jabstract_cache  # noqa
from repro.models import get_model as jget_model  # noqa: E402
from repro.models.losses import chunked_cross_entropy as jchunked  # noqa
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim.adamw import Q8State as JQ8  # noqa: E402

from _torch_ranks import run_ranks, split_train_counts  # noqa: E402

TOL = 1e-5
WORLD = 4
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model")),
          "1x4": ((1, 4), ("data", "model"))}
SEQ = 16          # smollm's rows (train and prefill); decode's cache
PROMPT = 12       # decode: each sequence at a position below PROMPT
DECODE_STEPS = 2
CLI_ARGS = ["--arch", "smollm-360m", "--smoke", "--batch", "8", "--seq",
            str(SEQ), "--device", "cpu", "--lr", "3e-3"]

# An arch name of a case that is an arch's smoke() config with fields
# replaced, in both packages alike.
VARIANTS = {"smollm-360m-6h": ("smollm-360m", {"n_heads": 6,
                                               "n_kv_heads": 2})}


# The weight classes a case's plan keeps whole along "model" (under
# auto's rules for a weight-gathered class), in place of its strategy's.
WHOLE_RULES = {k: "data" for k in ("vocab", "embed", "heads", "kv_heads",
                                   "ff", "experts")} | {"layers": None}
KEEP_WHOLE = {"smollm6h-wo-train-tp-1x4": ("wo",),
              "smollm6h-wo-serve-tp-1x4": ("wo",)}


def _jcfg(arch):
    """The reference's smoke() config of a case's arch (``VARIANTS``)."""
    name, fields = VARIANTS.get(arch, (arch, {}))
    return dataclasses.replace(JREGISTRY[name].smoke(), **fields)


# (id, kind, arch, mesh, strategy, state bits, global batch, seq)
CASES = []
for _m in MESHES:
    for _s in ("tp", "fsdp", "auto"):
        CASES.append((f"smollm-{_s}-{_m}", "train", "smollm-360m", _m, _s,
                      32, 8, SEQ))
    CASES.append((f"smollm-tp-8bit-{_m}", "train", "smollm-360m", _m, "tp",
                  8, 8, SEQ))
    for _s in ("tp", "fsdp", "auto"):
        CASES.append((f"smollm-prefill-{_s}-{_m}", "prefill", "smollm-360m",
                      _m, _s, 32, 8, SEQ))
        CASES.append((f"smollm-decode-{_s}-{_m}", "decode", "smollm-360m",
                      _m, _s, 32, 8, SEQ))
CASES += [
    ("granite-manual-tp-2x2", "train", "granite-moe-1b-a400m", "2x2", "tp",
     32, 8, 64),
    ("granite-manual-fsdp-2x2", "train", "granite-moe-1b-a400m", "2x2",
     "fsdp", 32, 8, 64),
    ("granite-manual-auto-2x1x2", "train", "granite-moe-1b-a400m", "2x1x2",
     "auto", 32, 8, 64),
    ("granite-global-tp-2x2", "train", "granite-moe-1b-a400m", "2x2", "tp",
     32, 2, 64),
    ("granite-prefill-manual-auto-2x2", "prefill", "granite-moe-1b-a400m",
     "2x2", "auto", 32, 8, 64),
    ("granite-decode-global-auto-2x2", "decode", "granite-moe-1b-a400m",
     "2x2", "auto", 32, 8, 64),
    # zamba2 at 2 x 16 a block: at 2 x 32, with these inputs, the f32
    # gradient of its first block is ill-conditioned (conv_w: repro's lies
    # 3.4e-5 of its largest from a float64 run of the same computation,
    # the port's 1.3e-5; tests/test_torch_f32_conditioning.py), so two f32
    # computations differ by 2.2e-5 there, over the 1e-5 bar (ROADMAP C.4).
    ("zamba2-auto-2x2", "train", "zamba2-7b", "2x2", "auto", 32, 4, 16),
    ("rwkv6-auto-2x2", "train", "rwkv6-7b", "2x2", "auto", 32, 4, 32),
    ("whisper-auto-2x2", "train", "whisper-base", "2x2", "auto", 32, 4, 32),
]
for _a in ("smollm-360m", "olmo-1b"):
    for _s in ("tp", "auto"):
        CASES.append((f"{_a.split('-')[0]}-serve-{_s}-1x4", "serve", _a,
                      "1x4", _s, 32, 8, SEQ))
# smollm-360m smoke with 6 / 2 heads of 16 on (1, 4): 4 does not divide
# 6, but it divides the 96 columns, so a block would cut a head (the
# "cut" case of smollm-360m's 15 heads on 4 or 16): wq / wk / wv are
# gathered over "model", attention runs every head on each rank, wo takes
# the rank's slice of every head's output, and the decode gathers each
# layer of the head_dim-split cache whole.
CASES.append(("smollm6h-serve-tp-1x4", "serve", "smollm-360m-6h", "1x4",
              "tp", 32, 8, SEQ))
# One sequence on (2, 2): every rank runs it, and the cache spec spreads
# the KV heads over ("data", "model"), so the decode gathers each cache
# leaf before the step (the one named exception).
CASES.append(("olmo-serve-tp-2x2-b1", "serve", "olmo-1b", "2x2", "tp", 32,
              1, SEQ))
# Train steps split over "model" on (1, 4): smollm's shared KV heads (the
# gathers' backward a reduce-scatter over the 2 ranks of a head) and its
# vocab-parallel head, olmo's whole heads, the 6 / 2 heads' cut case (wq
# / wk / wv gathered, reduce-scattered back); and auto at global batch 2
# on (2, 2): flat_dp is infeasible and the mixed plan keeps wk / wv
# weight-gathered while wq / wo / the MLP lie on "model", so attention
# cuts wk / wv locally and their gradients must be summed over "model".
CASES += [
    ("smollm-train-tp-1x4", "train", "smollm-360m", "1x4", "tp", 32, 8, SEQ),
    # the cut case with wo kept whole along "model" (KEEP_WHOLE): wo is
    # cut locally to the rank's rows against its slice of the duplicated
    # attention output and all-reduced, so its gradient is summed over
    # "model"; served, the same partial sums
    ("smollm6h-wo-train-tp-1x4", "train", "smollm-360m-6h", "1x4", "tp",
     32, 8, SEQ),
    ("smollm6h-wo-serve-tp-1x4", "serve", "smollm-360m-6h", "1x4", "tp",
     32, 8, SEQ),
    ("olmo-train-tp-1x4", "train", "olmo-1b", "1x4", "tp", 32, 8, SEQ),
    ("smollm6h-train-tp-1x4", "train", "smollm-360m-6h", "1x4", "tp", 32, 8,
     SEQ),
    ("smollm-train-auto-2x2-b2", "train", "smollm-360m", "2x2", "auto", 32,
     2, SEQ),
]

# The split's counters a (1, 4) serving case must give on every rank:
# a prefill's (4 layers), then 2 decode steps' (smoke configs: 4 layers).
_SHARED = {"model_gather:wk": 4, "model_gather:wv": 4, "kv_exchange": 8}
_CUT = {"model_gather:wq": 4, "model_gather:wk": 4, "model_gather:wv": 4}
_SHARED_DECODE = {"decode:shared_kv:1/1": 8, **{k: 2 * v for k, v in
                                               _SHARED.items()}}


def _train(flash: str, gathered=()) -> dict:
    """A split train step's counters at the smoke configs' 4 layers (no
    remat, one cross-entropy chunk, the embedding and head split over
    the vocab)."""
    return split_train_counts(4, flash, gathered=gathered)


SPLIT_EXPECT = {
    "smollm-serve-tp-1x4": ({"flash:shared_kv:1/1": 4, **_SHARED},
                            _SHARED_DECODE),
    # auto's prefill here is the sequence_parallel layout: no weight on
    # "model", so attention runs every head; its decode is mixed.
    "smollm-serve-auto-1x4": ({"flash:unsplit:4/2": 4}, _SHARED_DECODE),
    "olmo-serve-tp-1x4": ({"flash:whole:1/1": 4}, {"decode:whole:1/1": 8}),
    "olmo-serve-auto-1x4": ({"flash:whole:1/1": 4},
                            {"decode:whole:1/1": 8}),
    # the cut case: wq / wk / wv gathered a layer, every head on each
    # rank, the cache's head_dim blocks of a layer gathered for K and V
    "smollm6h-serve-tp-1x4": (
        {"flash:cut:6/2": 4, **_CUT},
        {"decode:cut:6/2": 8, **{k: 2 * v for k, v in _CUT.items()},
         "kv_layer_gather": 16}),
    "olmo-serve-tp-2x2-b1": ({"flash:whole:2/2": 4},
                             {"decode:whole:2/2": 8, "cache_leaf_gather": 4}),
}
SPLIT_EXPECT["smollm6h-wo-serve-tp-1x4"] = SPLIT_EXPECT[
    "smollm6h-serve-tp-1x4"]
# Each split train case: the counters of ``grads`` and of the step.
for _cid, _want in {
        "smollm-train-tp-1x4": _train("flash:shared_kv:1/1", ("wk", "wv")),
        "olmo-train-tp-1x4": _train("flash:whole:1/1"),
        "smollm6h-train-tp-1x4": _train("flash:cut:6/2", ("wq", "wk", "wv")),
        "smollm6h-wo-train-tp-1x4": _train("flash:cut:6/2",
                                           ("wq", "wk", "wv")),
        "smollm-train-auto-2x2-b2": _train("flash:whole:2/1"),
        **{f"smollm-{s}-{m}": _train("flash:whole:2/1")
           for s in ("tp", "auto", "tp-8bit") for m in ("2x2", "2x1x2")},
        }.items():
    SPLIT_EXPECT[_cid] = (_want, _want)

RANK_SCRIPT = r"""
import dataclasses
import json
import numpy as np
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.hw import MeshDescriptor
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_mesh_from_descriptor
from repro_torch.models import params_from_numpy
from repro_torch.optim import AdamW, Q8State
from repro_torch.parallel import make_plan
from repro_torch.parallel.placement import from_local, gather, placements
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.launch import train
from repro_torch.parallel.split import COUNTS

cases = json.load(open(os.path.join(WORK, "cases.json")))
meshes = {}


def unflat(arrs, prefix):
    tree = {}
    for k, v in arrs.items():
        if not k.startswith(prefix):
            continue
        *path, leaf = k[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def flat(tree, prefix):
    if isinstance(tree, Q8State):
        return {prefix + "#q": tree.q, prefix + "#scale": tree.scale}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def plan_of(cid, cfg, shape, shape_m, axes, strategy):
    plan = make_plan(cfg, shape, MeshDescriptor(tuple(shape_m), tuple(axes)),
                     strategy)
    for w in KEEP_WHOLE.get(cid, ()):
        plan.overrides[w] = WHOLE_RULES
    return plan


def check_placed(tree, specs, mesh):
    got, want = flat(tree, ""), flat(specs, "")
    for k, t in got.items():
        assert isinstance(t, DTensor), k
        assert tuple(t.placements) == tuple(placements(want[k], mesh)), k


for case in cases:
    cid, kind, arch, mname, strategy, bits, GB, S = case
    shape_m, axes = MESHES[mname]
    if mname not in meshes:
        meshes[mname] = make_mesh_from_descriptor(
            MeshDescriptor(tuple(shape_m), tuple(axes)), "cpu")
    mesh = meshes[mname]
    name, fields = VARIANTS.get(arch, (arch, {}))
    cfg = dataclasses.replace(get_config(name).smoke(), **fields)
    shape = ShapeSpec(cid, S, GB, "prefill" if kind == "serve" else kind)
    plan = plan_of(cid, cfg, shape, shape_m, axes, strategy)
    arrs = dict(np.load(os.path.join(WORK, f"{cid}.in.npz")))
    opt = AdamW(state_bits=bits)
    b = steps.build_step(cfg, shape, plan, mesh, optimizer=opt,
                         impl="reference")
    full = params_from_numpy(unflat(arrs, "p/"))
    params = steps.distribute_tree(full, b.specs["params"], mesh)
    check_placed(params, b.specs["params"], mesh)
    batch = {k[2:]: torch.from_numpy(v) for k, v in arrs.items()
             if k.startswith("b/")}
    out = {}
    counts = []
    COUNTS.clear()
    if kind == "train":
        state = steps.distribute_tree(opt.init(full), b.specs["opt_state"],
                                      mesh)
        check_placed(state, b.specs["opt_state"], mesh)
        loss, aux, grads = b.fn.grads(params, batch)
        counts.append(dict(COUNTS))
        grads = steps._walk(lambda g, s: gather(from_local(g, mesh, s)),
                            grads, b.specs["params"])
        out.update(flat(grads, "g"))
        COUNTS.clear()
        _, _, m = b.fn(params, state, batch)
        counts.append(dict(COUNTS))
        check_placed(params, b.specs["params"], mesh)
        out.update({"m/" + k: v for k, v in m.items()})
        out.update(flat(steps.gather_tree(params), "p"))
        out.update(flat(steps.gather_tree(state), "s"))
        if bits == 8:
            # A checkpoint of the sharded state (rank 0 writes the whole
            # tensors), restored into DTensors of the same placements.
            ck = os.path.join(WORK, cid + ".ckpt")
            save_checkpoint(ck, 1, (params, state))
            dist.barrier()
            like = (steps.distribute_tree(full, b.specs["params"], mesh),
                    steps.distribute_tree(opt.init(full),
                                          b.specs["opt_state"], mesh))
            (p2, s2), at = restore_checkpoint(ck, like)
            check_placed(p2, b.specs["params"], mesh)
            check_placed(s2, b.specs["opt_state"], mesh)
            back = {**flat(steps.gather_tree(p2), "p"),
                    **flat(steps.gather_tree(s2), "s")}
            out["ckpt_equal"] = torch.tensor(at == 1 and all(
                torch.equal(back[k], out[k]) for k in back))
    elif kind in ("prefill", "serve"):
        logits, cache = b.fn(params, batch)
        counts.append(dict(COUNTS))
        check_placed(cache, b.specs["cache"], mesh)
        out["logits"] = gather(logits)
        out.update(flat(steps.gather_tree(cache), "c" if kind == "prefill"
                        else "pc"))
        if kind == "serve":
            # 2 decode steps on the prefill's cache (its specs are the
            # decode plan's: the same batch and "model" fits).
            dshape = ShapeSpec(cid, S, GB, "decode")
            db = steps.build_step(cfg, dshape, plan_of(
                cid, cfg, dshape, shape_m, axes, strategy), mesh,
                impl="reference")
            dparams = steps.distribute_tree(full, db.specs["params"], mesh)
            check_placed(cache, db.specs["cache"], mesh)
            COUNTS.clear()
            for t in range(DECODE_STEPS):
                logits, cache = db.fn(dparams, cache, {
                    "tokens": torch.from_numpy(arrs[f"t{t}"])})
                check_placed(cache, db.specs["cache"], mesh)
                out[f"logits{t}"] = gather(logits)
            counts.append(dict(COUNTS))
            out.update(flat(steps.gather_tree(cache), "c"))
    else:
        cache = steps.distribute_tree(
            {k: torch.from_numpy(v) for k, v in unflat(arrs, "c/").items()},
            b.specs["cache"], mesh)
        for t in range(DECODE_STEPS):
            logits, cache = b.fn(params, cache,
                                 {"tokens": torch.from_numpy(arrs[f"t{t}"])})
            check_placed(cache, b.specs["cache"], mesh)
            out[f"logits{t}"] = gather(logits)
        counts.append(dict(COUNTS))
        out.update(flat(steps.gather_tree(cache), "c"))
    with open(os.path.join(WORK, f"{cid}.counts{RANK}.json"), "w") as f:
        json.dump(counts, f)
    if RANK == 0:
        np.savez(os.path.join(WORK, f"{cid}.out.npz"),
                 **{k: v.detach().float().numpy() if v.dtype == torch.bfloat16
                    else v.detach().numpy() for k, v in out.items()})

# The CLI on the world's (2, 2) mesh: 2 steps, then a resume to 3.
argv = CLI_ARGS + ["--strategy", "auto", "--ckpt-dir",
                   os.path.join(WORK, "cli"), "--ckpt-every", "2"]
runs = [train.main(argv + ["--steps", str(n)]) for n in (2, 3)]
if RANK == 0:
    json.dump({"losses": [r["loss"] for run in runs
                          for r in run["trainer"].metrics_history],
               "mesh": list(runs[0]["mesh"].shape),
               "layout": runs[0]["plan"].decisions.get("layout")},
              open(os.path.join(WORK, "cli.json"), "w"))
"""


def _flat(tree, prefix=""):
    if isinstance(tree, JQ8):
        return {prefix + "#q": tree.q, prefix + "#scale": tree.scale}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _unflat(flat, prefix):
    tree = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        *path, leaf = k[len(prefix):].split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


_PARAMS = {}


def _numpy_init(defs, rng):
    """A ParamDef tree drawn with numpy by each leaf's init kind, as the
    reference's ``init_params`` draws it (fan-in scaled normal, the
    stacked layer axis excluded; 0.02 for embeddings; zeros, ones)."""
    out = {}
    for k, d in defs.items():
        if isinstance(d, dict):
            out[k] = _numpy_init(d, rng)
        elif d.init in ("zeros", "ones"):
            out[k] = np.full(d.shape, d.init == "ones", np.float32)
        else:
            fan = d.shape[1:] if d.axes and d.axes[0] == "layers" \
                else d.shape
            scale = d.init_scale or (0.02 if d.init == "embed" else (
                np.prod(fan[:-1]) if len(fan) > 1 else fan[0]) ** -0.5)
            out[k] = (rng.standard_normal(d.shape) * scale).astype(
                np.float32)
    return out


def _params(arch):
    """Smoke params of ``arch`` drawn with numpy (one draw an arch)."""
    if arch not in _PARAMS:
        jcfg = _jcfg(arch)
        _PARAMS[arch] = _numpy_init(jget_model(jcfg).param_defs(jcfg),
                                    np.random.default_rng(0))
    return _PARAMS[arch]


def _inputs(case):
    """The case's numpy inputs: the params, the batch, and for a decode
    a cache of random rows (every sequence at its own position) and the
    tokens of each step."""
    cid, kind, arch, _, _, _, GB, S = case
    jcfg = _jcfg(arch)
    api = jget_model(jcfg)
    rng = np.random.default_rng(sum(map(ord, cid)))
    arrs = {"p/" + k: v for k, v in _flat(_params(arch)).items()}
    if kind == "decode":
        for k, v in jabstract_cache(jcfg, GB, S).items():
            arrs["c/" + k] = (
                rng.integers(PROMPT // 2, PROMPT, v.shape).astype(v.dtype)
                if k == "pos" else
                rng.standard_normal(v.shape).astype(v.dtype))
        for t in range(DECODE_STEPS):
            arrs[f"t{t}"] = rng.integers(0, jcfg.vocab, (GB,)).astype(
                np.int32)
        return arrs
    arrs["b/tokens"] = rng.integers(0, jcfg.vocab, (GB, S)).astype(np.int32)
    if kind == "serve":
        for t in range(DECODE_STEPS):
            arrs[f"t{t}"] = rng.integers(0, jcfg.vocab, (GB,)).astype(
                np.int32)
    if kind == "train":
        arrs["b/labels"] = rng.integers(0, jcfg.vocab, (GB, S)).astype(
            np.int32)
    if api.extra_input == "encoder_frames":
        arrs["b/encoder_frames"] = rng.standard_normal(
            (GB, jcfg.encoder_seq, jcfg.d_model)).astype(np.float32)
    return arrs


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case's inputs and rank 0's outputs."""
    work = str(tmp_path_factory.mktemp("sharded"))
    inputs = {}
    for case in CASES:
        inputs[case[0]] = _inputs(case)
        np.savez(os.path.join(work, f"{case[0]}.in.npz"), **inputs[case[0]])
    with open(os.path.join(work, "cases.json"), "w") as f:
        json.dump(CASES, f)
    script = (f"MESHES = {MESHES!r}\nDECODE_STEPS = {DECODE_STEPS}\n"
              f"VARIANTS = {VARIANTS!r}\nKEEP_WHOLE = {KEEP_WHOLE!r}\n"
              f"WHOLE_RULES = {WHOLE_RULES!r}\n"
              f"CLI_ARGS = {CLI_ARGS!r}\n" + RANK_SCRIPT)
    _, oracles = run_ranks(script, work, WORLD, timeout=400,
                           meanwhile=lambda: _all_oracles(inputs))
    outs = {c[0]: dict(np.load(os.path.join(work, f"{c[0]}.out.npz")))
            for c in CASES}
    outs["cli"] = json.load(open(os.path.join(work, "cli.json")))
    return inputs, oracles, outs, work


def _n_blocks(jcfg, case):
    """The oracle's batch blocks: MoE's manual path dispatches each
    ("pod", "data") block on its own, its global path every row at
    once; a dense loss is the same mean over any equal blocks."""
    _, _, _, mname, _, _, GB, S = case
    sizes = dict(zip(MESHES[mname][1], MESHES[mname][0]))
    blocks = sizes.get("pod", 1) * sizes.get("data", 1)
    if jcfg.n_experts and GB * S // blocks < max(jcfg.top_k, 256):
        return 1
    return blocks


_JIT = {}


def _jit(key, make):
    if key not in _JIT:
        _JIT[key] = make()
    return _JIT[key]


def _jloss(jcfg):
    """``repro``'s step loss (``repro/launch/steps.py::build_step``) and
    its gradients."""
    api = jget_model(jcfg)

    def loss_fn(p, batch):
        kw = ({"encoder_frames": batch["encoder_frames"]}
              if "encoder_frames" in batch else {})
        out = api.forward(p, batch["tokens"], jcfg, impl="reference",
                          return_hidden=True, **kw)
        head = p["embed"].T if jcfg.tie_embeddings else p["lm_head"]
        loss = jchunked(out["hidden"], head, batch["labels"])
        aux = out.get("aux", {})
        if "lb_loss" in aux:
            loss = loss + AUX_LOSS_WEIGHT * aux["lb_loss"]
        return loss, aux
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _params_of(arrs):
    return jax.tree.map(jnp.asarray, _unflat(arrs, "p/"))


def _train_oracle(case, arrs):
    """The block oracle: (mean loss, mean imbalance or None, averaged
    gradients as a flat dict)."""
    cid, _, arch, _, _, _, GB, _ = case
    jcfg = _jcfg(arch)
    fn = _jit(("loss", arch), lambda: _jloss(jcfg))
    params = _params_of(arrs)
    batch = {k[2:]: v for k, v in arrs.items() if k.startswith("b/")}
    n = _n_blocks(jcfg, case)
    losses, grads, imb = [], [], []
    for i in range(n):
        blk = {k: jnp.asarray(v[i * GB // n:(i + 1) * GB // n])
               for k, v in batch.items()}
        (loss, aux), g = fn(params, blk)
        losses.append(float(loss))
        grads.append(_flat(jax.tree.map(np.asarray, g)))
        if "imbalance_pct" in aux:
            imb.append(float(aux["imbalance_pct"]))
    mean = {k: sum(g[k] for g in grads) / n for k in grads[0]}
    # Compile the AdamW oracle now, off the test's clock: the test runs
    # it on the step's gradients, of the same shapes.
    _adamw(arch, case[5])(jax.tree.map(jnp.asarray, _unflat(
        {"g/" + k: v for k, v in mean.items()}, "g/")), params)
    return (np.mean(losses), np.mean(imb) if imb else None, mean)


def _adamw(arch, bits):
    """The reference's single-device AdamW update from a fresh state."""
    jopt = JAdamW(state_bits=bits)
    return _jit(("adamw", arch, bits), lambda: jax.jit(
        lambda g, p: jopt.update(g, jopt.init(p), p)))


def _prefill_oracle(case, arrs):
    """The legacy forward's last-position logits and cache, per MoE
    block where the manual path splits the rows."""
    cid, _, arch, _, _, _, GB, S = case
    jcfg = _jcfg(arch)
    api = jget_model(jcfg)

    def legacy(params, tokens):
        out = api.forward(params, tokens, jcfg, impl="reference",
                          return_cache=True, return_hidden=True,
                          cache_len=S)
        head = (params["embed"].T if jcfg.tie_embeddings
                else params["lm_head"])
        return out["hidden"][:, -1] @ head, out["cache"]
    fn = _jit(("prefill", arch, S), lambda: jax.jit(legacy))
    params = _params_of(arrs)
    n = _n_blocks(jcfg, case) if jcfg.n_experts else 1
    toks = arrs["b/tokens"]
    parts = [fn(params, jnp.asarray(toks[i * GB // n:(i + 1) * GB // n]))
             for i in range(n)]
    out = {"logits": np.concatenate([np.asarray(p[0]) for p in parts])}
    for k in parts[0][1]:
        out["c/" + k] = np.concatenate([np.asarray(p[1][k]) for p in parts],
                                       0 if k == "pos" else 1)
    return out


def _decode_oracle(case, arrs):
    """DECODE_STEPS legacy decode steps on every row."""
    cid, _, arch, _, _, _, _, _ = case
    jcfg = _jcfg(arch)
    api = jget_model(jcfg)
    fn = _jit(("decode", arch), lambda: jax.jit(
        lambda p, c, t: api.decode_step(p, c, t, jcfg, impl="reference")))
    params = _params_of(arrs)
    cache = {k: jnp.asarray(v) for k, v in _unflat(arrs, "c/").items()}
    out = {}
    for t in range(DECODE_STEPS):
        logits, cache = fn(params, cache, jnp.asarray(arrs[f"t{t}"]))
        out[f"logits{t}"] = np.asarray(logits)
    out.update({"c/" + k: np.asarray(v) for k, v in cache.items()})
    return out


def _serve_oracle(case, arrs):
    """The legacy forward's last-position logits and cache, then
    DECODE_STEPS legacy decode steps on that cache."""
    cid, _, arch, _, _, _, _, _ = case
    out = _prefill_oracle(case, arrs)
    cache = {k[2:]: jnp.asarray(v) for k, v in out.items()
             if k.startswith("c/")}
    out = {("p" + k if k.startswith("c/") else k): v
           for k, v in out.items()}
    jcfg = _jcfg(arch)
    api = jget_model(jcfg)
    fn = _jit(("decode", arch), lambda: jax.jit(
        lambda p, c, t: api.decode_step(p, c, t, jcfg, impl="reference")))
    params = _params_of(arrs)
    for t in range(DECODE_STEPS):
        logits, cache = fn(params, cache, jnp.asarray(arrs[f"t{t}"]))
        out[f"logits{t}"] = np.asarray(logits)
    out.update({"c/" + k: np.asarray(v) for k, v in cache.items()})
    return out


ORACLES = {"train": _train_oracle, "prefill": _prefill_oracle,
           "decode": _decode_oracle, "serve": _serve_oracle}


def _all_oracles(inputs) -> dict:
    """Every case's oracle, one thread an arch (each arch's jitted
    functions compile in its own thread, beside the others)."""
    by_arch = {}
    for c in CASES:
        by_arch.setdefault(c[2], []).append(c)
    with ThreadPoolExecutor(len(by_arch)) as pool:
        parts = pool.map(lambda cs: {c[0]: ORACLES[c[1]](c, inputs[c[0]])
                                     for c in cs}, by_arch.values())
        return {k: v for part in parts for k, v in part.items()}


def _close(got, want, what, rel=True):
    """Within TOL of the largest |want| (rel) or absolutely."""
    scale = np.abs(want).max() if rel else 1.0
    diff = np.abs(np.asarray(got, np.float64) - want).max()
    assert diff <= TOL * scale, (what, diff, scale)


def _cases(kind):
    return [pytest.param(c, id=c[0]) for c in CASES if c[1] == kind]


def _get(tree, path):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("case", _cases("train"))
def test_sharded_train_step_matches_block_oracle(world, case):
    inputs, oracles, outs, _ = world
    cid, _, arch, _, _, bits, _, _ = case
    out = outs[cid]
    loss, imb, want_g = oracles[cid]
    assert abs(float(out["m/loss"]) - loss) <= TOL, cid
    if imb is not None:
        assert abs(float(out["m/moe_imbalance_pct"]) - imb) <= \
            1e-4 * max(1.0, abs(imb)), cid
    for path, w in want_g.items():
        _close(out["g/" + path], w, (cid, "grad", path))
    # The reference's single-device AdamW on the step's gradients.
    new_p, new_s, m = _adamw(arch, bits)(
        jax.tree.map(jnp.asarray, _unflat(out, "g/")),
        _params_of(inputs[cid]))
    assert abs(float(out["m/grad_norm"]) - float(m["grad_norm"])) <= \
        TOL * float(m["grad_norm"]), cid
    for path, w in _flat(jax.tree.map(np.asarray, new_p)).items():
        _close(out["p/" + path], w, (cid, "param", path), rel=False)
    for mom in ("m", "v"):
        for path, w in _flat(new_s[mom]).items():
            if bits == 32:
                _close(out[f"s/{mom}/{path}"], np.asarray(w),
                       (cid, mom, path))
            elif path.endswith("#q"):
                # The row scales within TOL; each int8 value on the same
                # step of the grid or the next (a value within TOL of a
                # half step may round either way).
                base = path[:-2]
                want = _get(new_s[mom], base)
                _close(out[f"s/{mom}/{base}#scale"], np.asarray(want.scale),
                       (cid, mom, base, "scale"))
                step = np.abs(out[f"s/{mom}/{base}#q"].astype(np.int32)
                              - np.asarray(want.q).astype(np.int32)).max()
                assert step <= 1, (cid, mom, base, step)


@pytest.mark.parametrize("case", _cases("prefill"))
def test_sharded_prefill_matches_legacy_forward(world, case):
    _, oracles, outs, _ = world
    for k, w in oracles[case[0]].items():
        _close(outs[case[0]][k], w, (case[0], k))


@pytest.mark.parametrize("case", _cases("decode"))
def test_sharded_decode_matches_decode_step(world, case):
    _, oracles, outs, _ = world
    for k, w in oracles[case[0]].items():
        _close(outs[case[0]][k], w, (case[0], k))


@pytest.mark.parametrize("case", _cases("serve"))
def test_sharded_prefill_then_decode_matches_legacy(world, case):
    """A split prefill on (1, 4), then 2 split decode steps on the
    cache it returned, against the legacy forward and decode step."""
    _, oracles, outs, _ = world
    for k, w in oracles[case[0]].items():
        _close(outs[case[0]][k], w, (case[0], k))


@pytest.mark.parametrize("case", [pytest.param(c, id=c[0]) for c in CASES])
def test_split_counters_on_every_rank(world, case):
    """Each rank's split counters: a dense case under tp or auto ran
    split (its head case and head counts a layer, exactly as
    ``SPLIT_EXPECT`` says where it names the case: every split train
    case, with its forward and backward all-reduces, gathers and
    reduce-scatters) and gathered no whole cache leaf but where
    ``SPLIT_EXPECT`` says so; fsdp and the other families ran
    weight-gathered, with nothing counted."""
    cid, kind, arch, mname, strategy = case[:5]
    work = world[3]
    jcfg = _jcfg(arch)
    L = jcfg.n_layers
    for rank in range(WORLD):
        counts = json.load(open(os.path.join(work,
                                             f"{cid}.counts{rank}.json")))
        if jcfg.family != "dense" or strategy == "fsdp":
            assert counts == [{}] * len(counts), (cid, rank, counts)
            continue
        if cid in SPLIT_EXPECT:
            assert counts == list(SPLIT_EXPECT[cid]), (cid, rank, counts)
        # a prefill's flash launches, then the decode steps'
        want = {"prefill": [L], "decode": [L * DECODE_STEPS],
                "serve": [L, L * DECODE_STEPS], "train": [L, L]}[kind]
        for c, n in zip(counts, want, strict=True):
            assert "cache_leaf_gather" not in c or cid in SPLIT_EXPECT, \
                (cid, rank, c)
            assert sum(v for k, v in c.items() if k.split(":")[0] in (
                "flash", "decode")) == n, (cid, rank, c)


@pytest.mark.parametrize("case", [c for c in _cases("train")
                                  if c.values[0][5] == 8])
def test_sharded_checkpoint_round_trip(world, case):
    """Rank 0 writes the gathered DTensor state; a restore into DTensors
    of the same placements gives back every leaf bit for bit."""
    _, _, outs, _ = world
    assert bool(outs[case[0]]["ckpt_equal"]), case[0]


def test_cli_strategy_trains_resumes_and_matches_one_device(world, tmp_path):
    """``launch.train --strategy auto`` on the 4 ranks' (2, 2) mesh, 2
    steps and a resume from their checkpoint to 3, gives the losses of
    the single-device CLI's 3 steps (within 1e-5)."""
    from repro_torch.launch import train
    _, _, outs, _ = world
    cli = outs["cli"]
    assert cli["mesh"] == [2, 2] and cli["layout"] is not None
    one = train.main(CLI_ARGS + ["--steps", "3", "--ckpt-dir",
                                 str(tmp_path)])
    want = [r["loss"] for r in one["trainer"].metrics_history]
    assert len(cli["losses"]) == 3
    np.testing.assert_allclose(cli["losses"], want, rtol=0, atol=TOL)
