"""Step builders: the single-device training step and the sharded
train / prefill / decode steps (counterpart of
``repro/launch/steps.py``).

One step, for every family: the family's legacy forward
(``get_model(cfg).forward``, with the batch's extra input --
``vision_embeds`` for the vlm, ``encoder_frames`` for audio -- where the
family names one) with ``return_hidden`` (remat by default from 16
layers on, as the reference), the chunked cross-entropy against
the head (``embed.T`` when the embeddings are tied) plus
``AUX_LOSS_WEIGHT`` times the MoE layers' load-balance loss, gradients
by autograd, then the AdamW update.

``build_train_step`` is that step on one device.  The reference jits
the step and donates the params and the optimizer state.  Here the step
updates both in place (``AdamW.update``), and on the card it runs off a
CUDA graph through the executor's ``GraphStore``: the first call runs
eagerly and is the real first step, the second is captured and
replayed, later ones replay.  The batch is copied into the graph's
static inputs (the extra input beside the tokens and labels), the
gradients live in its memory pool, and the metrics are cloned out after
each replay.  The graph is keyed on the batch shapes and the addresses
of the params and state it was captured on, so state that comes back
from a checkpoint as new tensors gets a graph of its own (the step
keeps one).  On the CPU, and inside ``executor.disable_graphs()``,
every call runs eagerly.

The spec half is the reference's, allocation-free: ``input_specs`` and
``abstract_*`` return tensors on the ``meta`` device, and
``batch_pspecs`` / ``cache_pspecs`` / ``opt_state_pspecs`` the ``P``
trees a ``ShardingPlan`` gives them.  ``build_step`` is the sharded step
of one (arch x shape) cell on a ``DeviceMesh`` (``launch/mesh.py``):
every parameter and moment leaf is a ``DTensor`` under its spec
(``parallel/placement.py``), and each rank runs the rows
``batch_pspecs`` fits for each input (all rows where the batch is left
unsharded; the ranks along an axis that carries no batch run the same
rows).

The dense family's train, prefill and decode steps run split over
"model" wherever the rank's rows do not lie on it (``tp``, and
``auto``'s ``mixed`` and ``sequence_parallel`` layouts; not ``fsdp``,
whose rows do, nor ``auto``'s ``flat_dp``): each leaf is gathered over
the mesh axes of its spec other than "model" (the FSDP side: ``"embed":
"data"``, the weight-gathered classes) and keeps its "model" block as
stored; the forward runs the rank's columns, rows, heads and vocab rows
through the ``Split`` it finds in the ``activation_rules`` context
(``parallel/split.py``: column- and row-parallel projections, attention
on the rank's heads through the kernels, the cache kept in its blocks,
a vocab-parallel embedding and head); logits and caches come back as
the rank's blocks under the reference's specs, with no gather.  A class
the plan keeps off "model" (every class of the ``sequence_parallel``
prefill) runs as on one device.  A split train step runs the backward
on the same blocks through the split's autograd collectives and the
vocab-parallel cross-entropy (``models/losses.py``), so each gradient
comes out as the rank's "model" block: one stored on "model" is whole
for its block; one of a leaf kept whole along "model" that a split
sublayer cuts locally (``Split.cut_locally``) holds only the rank's
part and is summed over "model" with the batch average, in one
all-reduce per dtype; every other (the norms, an unsplit embedding or
head) is equal on every "model" rank and only averaged.  Each is then
cut over its other axes and AdamW updates the blocks in place
(``AdamW.update(..., shards=)``).

Everything else -- every other family's steps, ``fsdp`` and
``flat_dp`` -- is weight-gathered: each leaf is gathered whole before
the forward and freed after, the rank runs the single-device forward
(and backward) on its rows (the card's kernels unchanged, on plain
tensors), the gradients are averaged over the batch group, each rank
keeps its block and AdamW updates the blocks.  There MoE's experts and
the other families' activation-gathered classes run duplicated along
"model": the results are the reference's, the compute is not split
(ROADMAP A.12 c).  The steps run eagerly: no collective is captured in
a CUDA graph.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist

from ..checkpoint.store import tree_leaves, tree_unflatten
from ..configs.base import ArchConfig, ShapeSpec
from ..models import abstract_params, get_model, param_pspecs
from ..models.losses import chunked_cross_entropy
from ..optim import AdamW, LeafShards, Q8State
from ..parallel.act_sharding import (ActivationRules, P, activation_rules,
                                     mesh_sizes)
from ..parallel.placement import (axes_of, distribute, from_local, gather,
                                  gather_dim, group_size_rank, local_part,
                                  mesh_group, spec_of)
from ..parallel.rules import ShardingPlan
from ..parallel.split import COUNTS as SPLIT_COUNTS
from ..parallel.split import Split
from ..parallel.split import active as split_active
from ..runtime import executor

__all__ = ["AUX_LOSS_WEIGHT", "loss_and_grads", "build_train_step",
           "step_key", "StepBundle", "input_specs", "batch_pspecs",
           "cache_pspecs", "opt_state_pspecs", "abstract_train_state",
           "abstract_cache", "build_step", "distribute_tree", "gather_tree"]

AUX_LOSS_WEIGHT = 0.01


def _loss_aux_grads(cfg: ArchConfig, params, batch, *, impl: str,
                    remat: bool):
    """(loss, aux, grads): the training loss of one batch, the forward's
    MoE statistics and the loss's gradient in every parameter."""
    api = get_model(cfg)
    extra = api.extra_input
    kw = {extra: batch[extra]} if extra in batch else {}
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    sp = split_active()
    with torch.enable_grad():
        out = api.forward(p, batch["tokens"], cfg, impl=impl, remat=remat,
                          return_hidden=True, **kw)
        head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
        loss = chunked_cross_entropy(
            out["hidden"], head, batch["labels"],
            group=None if sp is None else sp.head_group)
        aux = out["aux"]
        if "lb_loss" in aux:
            loss = loss + AUX_LOSS_WEIGHT * aux["lb_loss"]
        grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in aux.items()},
            tree_unflatten(params, list(grads)))


def loss_and_grads(cfg: ArchConfig, params, batch, *, impl: str = "auto",
                   remat: bool = False):
    """(loss, grads): the mean token CE of one batch (with the MoE
    load-balance term) and its gradient in every parameter, a tree like
    ``params``.  ``batch`` holds "tokens" and "labels" (B, S) and, for
    the vlm and audio families, their extra input."""
    loss, _, grads = _loss_aux_grads(cfg, params, batch, impl=impl,
                                     remat=remat)
    return loss, grads


def build_train_step(cfg: ArchConfig, optimizer: AdamW | None = None, *,
                     impl: str = "auto", remat: bool | None = None):
    """The step (params, opt_state, batch) -> (params, opt_state,
    metrics), the params and state updated in place and returned;
    ``batch`` holds "tokens" and "labels" (B, S) and, for the vlm and
    audio families, their extra input: ``vision_embeds`` (B,
    n_vision_tokens, D) or ``encoder_frames`` (B, T_enc, D), taken in
    the config's type as the reference's ``input_specs`` declare it.
    ``metrics``: "loss", "grad_norm", "lr" and, for an MoE config,
    "moe_imbalance_pct".  The step's graphs are its ``graphs`` attribute
    (a ``GraphStore``)."""
    optimizer = optimizer or AdamW()
    if remat is None:
        remat = cfg.n_layers >= 16
    extra = get_model(cfg).extra_input
    store = executor.GraphStore()

    def train_step(params, opt_state, batch):
        dev = tree_leaves(params)[0].device
        names, inputs = ["tokens", "labels"], [batch["tokens"],
                                               batch["labels"]]
        if extra in batch:
            names.append(extra)
            inputs.append(batch[extra].to(dev, cfg.tdtype))

        def step(*xs):
            loss, aux, grads = _loss_aux_grads(
                cfg, params, dict(zip(names, xs)), impl=impl, remat=remat)
            metrics = {"loss": loss,
                       **optimizer.update(grads, opt_state, params)[2]}
            if "imbalance_pct" in aux:
                metrics["moe_imbalance_pct"] = aux["imbalance_pct"]
            return metrics

        if not executor._graphable(dev):
            return params, opt_state, step(*(x.to(dev) for x in inputs))
        key = step_key(inputs, params, opt_state)
        if key not in store.graphs:
            store.graphs.clear()        # another state: drop its graph
        return params, opt_state, store.run(key, step, inputs, dev)

    train_step.graphs = store
    return train_step


def step_key(inputs, params, opt_state) -> tuple:
    """The graphed step's key: the shapes and types of the batch's
    tensors (tokens, labels and the extra input, all static inputs of
    the graph, copied in on every call) and the addresses of the params
    and state the graph reads and writes where they lie."""
    return (executor._shapes(inputs),
            tuple((t.data_ptr(), t.shape, t.dtype)
                  for t in tree_leaves((params, opt_state))))


# --- input specs ------------------------------------------------------------------
def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """``meta`` tensors standing in for every model input of this cell."""
    GB, S = shape.global_batch, shape.seq_len

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")
    if shape.kind == "train":
        specs = {"tokens": meta((GB, S)), "labels": meta((GB, S))}
    elif shape.kind == "prefill":
        specs = {"tokens": meta((GB, S))}
    else:  # decode: one new token each; the cache is a separate operand
        specs = {"tokens": meta((GB,))}
    api = get_model(cfg)
    if api.extra_input == "vision_embeds" and shape.kind != "decode":
        specs["vision_embeds"] = meta((GB, cfg.n_vision_tokens, cfg.d_model),
                                      cfg.tdtype)
    if api.extra_input == "encoder_frames" and shape.kind != "decode":
        specs["encoder_frames"] = meta((GB, cfg.encoder_seq, cfg.d_model),
                                       cfg.tdtype)
    return specs


def _axis_total(mesh_sizes: dict, entry) -> int:
    total = 1
    for n in axes_of(entry):
        total *= mesh_sizes.get(n, 1)
    return total


def _fit(shape: tuple, mesh_sizes: dict, *entries) -> P:
    """Divisibility-checked spec: non-dividing entries fall to None;
    each mesh axis used at most once."""
    used: set[str] = set()
    fixed = []
    for dim, e in zip(shape, entries):
        names = axes_of(e)
        total = _axis_total(mesh_sizes, e)
        if not names or dim % total != 0 or any(n in used for n in names):
            fixed.append(None)
        else:
            used.update(names)
            fixed.append(e)
    return P(*fixed)


def _batch_candidates(dp) -> list:
    """Fallback chain for the batch axis: the full dp spec, then every
    contiguous sub-tuple by decreasing coverage (e.g. 256-batch on a
    512-chip flat axis falls back to (data, model))."""
    if isinstance(dp, str) or dp is None:
        return [dp]
    cands = []
    n = len(dp)
    for size in range(n, 0, -1):
        for start in range(0, n - size + 1):
            cands.append(tuple(dp[start:start + size]))
    return cands


def batch_pspecs(cfg: ArchConfig, shape: ShapeSpec, plan: ShardingPlan,
                 mesh_sizes: dict) -> dict:
    dp = plan.batch_spec[0]
    out = {}
    for k, v in input_specs(cfg, shape).items():
        spec = P(*([None] * v.ndim))
        for cand in _batch_candidates(dp):
            trial = _fit(v.shape, mesh_sizes, cand, *([None] * (v.ndim - 1)))
            if trial[0] is not None:
                spec = trial
                break
        out[k] = spec
    return out


def cache_pspecs(cache_abstract: dict, plan: ShardingPlan,
                 mesh_sizes: dict) -> dict:
    """Per-key cache sharding: batch over dp, heads over model, with
    divisibility-aware fallback (kv_heads < model axis -> shard head_dim;
    batch=1 long-context -> shard heads over the data axes too)."""
    dp = plan.batch_spec[0]
    specs = {}
    for k, v in cache_abstract.items():
        sh = tuple(v.shape)
        if k == "pos":
            specs[k] = _fit(sh, mesh_sizes, dp)
        elif k in ("k", "v", "cross_k", "cross_v", "attn_k", "attn_v"):
            # (L, B, KV, S, hd): prefer heads on model, else head_dim.
            s = _fit(sh, mesh_sizes, None, dp, "model", None, None)
            if s[2] is None:
                s = _fit(sh, mesh_sizes, None, dp, None, None, "model")
            if s[1] is None:   # batch not shardable: spread heads wider
                s2 = _fit(sh, mesh_sizes, None, None, (dp, "model")
                          if isinstance(dp, str) else tuple(dp) + ("model",),
                          None, None)
                if s2[2] is not None:
                    s = s2
            specs[k] = s
        elif k in ("ssm", "wkv"):            # (L, B, H, N, P)
            s = _fit(sh, mesh_sizes, None, dp, "model", None, None)
            if s[2] is None:
                s = _fit(sh, mesh_sizes, None, dp, None, None, "model")
            specs[k] = s
        elif k == "conv":                    # (L, B, K, C)
            specs[k] = _fit(sh, mesh_sizes, None, dp, None, "model")
        elif k in ("shift_t", "shift_c"):    # (L, B, D)
            specs[k] = _fit(sh, mesh_sizes, None, dp, "model")
        else:
            specs[k] = P(*([None] * len(sh)))
    return specs


def _leafmap(fn, tree):
    """``fn`` over the leaves of a tree of dicts and Q8States (a spec
    tree's leaves are its ``P``s)."""
    if isinstance(tree, dict):
        return {k: _leafmap(fn, v) for k, v in tree.items()}
    if isinstance(tree, Q8State):
        return Q8State(fn(tree.q), fn(tree.scale))
    return fn(tree)


def opt_state_pspecs(param_specs: dict, state_bits: int) -> dict:
    """Optimizer-state specs mirror the (ZeRO-sharded) param specs.

    8-bit moments: Q8State(q like the param, scale with the last axis
    unsharded -- it is reduced to length 1)."""
    if state_bits == 8:
        def expand(spec):
            entries = list(spec)
            scale_entries = entries[:-1] + [None] if entries else []
            return Q8State(q=spec, scale=P(*scale_entries))
        m = _leafmap(expand, param_specs)
        return {"m": m, "v": m, "step": P()}
    return {"m": param_specs, "v": param_specs, "step": P()}


# --- abstract state ---------------------------------------------------------------
def abstract_train_state(cfg: ArchConfig, optimizer: AdamW):
    """(params, opt_state, defs) on the ``meta`` device: no storage."""
    defs = get_model(cfg).param_defs(cfg)
    params = abstract_params(defs)
    return params, optimizer.init(params), defs


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    return get_model(cfg).init_cache(cfg, batch, max_len, device="meta")


# --- the sharded steps ------------------------------------------------------------
@dataclass
class StepBundle:
    fn: Any                      # the step
    args: tuple                  # abstract operands in call order
    specs: dict = field(default_factory=dict)   # operand name -> P tree
    mesh: Any = None


def _walk(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts and Q8States."""
    if isinstance(tree, dict):
        return {k: _walk(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, Q8State):
        return Q8State(fn(tree.q, specs.q), fn(tree.scale, specs.scale))
    return fn(tree, specs)


def distribute_tree(tree, specs, mesh):
    """A tree of full tensors (the same on every rank) as DTensors under
    ``specs``."""
    return _walk(lambda t, s: distribute(t, mesh, s), tree, specs)


def gather_tree(tree):
    """The full tensors of a tree of DTensors (every rank must call)."""
    return _leafmap(gather, tree)


def _local(t):
    """A DTensor's local block, its own storage: an update in place
    lands in the DTensor."""
    return t.to_local()


def _to_spec(t, dim: int, have: tuple, spec: P, mesh, local=()):
    """This rank's block under ``spec`` of a tensor of which ``t`` holds
    this rank's rows along ``dim``, rows split over the mesh axes
    ``have``, and already this rank's block along the dims ``local``: a
    slice where ``spec`` splits the rows the same way, else the rows of
    the batch group gathered first.  Returns a DTensor."""
    done = set(local)
    if axes_of(spec[dim]) == have:
        done.add(dim)
    else:
        t = gather_dim(t, dim, mesh_group(mesh, have))
    rest = P(*(None if d in done else e for d, e in enumerate(spec)))
    return from_local(local_part(t, mesh, rest).contiguous(), mesh, spec)


def _split_block(t, mesh, rows: tuple, row_dim: int | None = None,
                 count: str | None = None):
    """A split step's operand from a DTensor: its "model" block as
    stored (an entry that is "model" alone), the rank's rows along
    ``row_dim`` (rows split over the mesh axes ``rows``), every other
    dim gathered over the mesh axes its entry names (a group of one
    moves nothing; ``count`` names the ``SPLIT_COUNTS`` entry a gather
    adds to)."""
    spec = spec_of(t)
    out = t.to_local()
    for d, e in enumerate(spec):
        if e == "model" or (d == row_dim and axes_of(e) == rows):
            continue
        group = mesh_group(mesh, e)
        if group_size_rank(group)[0] > 1:
            out = gather_dim(out, d, group)
            if count:
                SPLIT_COUNTS[count] += 1
    if row_dim is not None and axes_of(spec[row_dim]) != rows:
        out = local_part(out, mesh, P(*[None] * row_dim, rows))
    return out


def _batch_average(leaves: list, group, n: int) -> list:
    """Each leaf summed over ``group`` and divided by its size ``n``:
    one all-reduce per dtype over the leaves laid end to end."""
    out = list(leaves)
    for dtype in {t.dtype for t in leaves}:
        idx = [i for i, t in enumerate(leaves) if t.dtype == dtype]
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        if n > 1:
            flat = flat / n
        for i, part in zip(idx, flat.split([leaves[i].numel()
                                            for i in idx])):
            out[i] = part.view(leaves[i].shape)
    return out


def _leaf_shards(mesh, spec: P, numel: int) -> LeafShards:
    names = tuple(n for e in spec for n in axes_of(e))
    return LeafShards(whole=mesh_group(mesh, names),
                      last=mesh_group(mesh, axes_of(spec[-1]))
                      if len(spec) else None, numel=numel)


def build_step(cfg: ArchConfig, shape: ShapeSpec, plan: ShardingPlan,
               mesh, *, optimizer: AdamW | None = None,
               impl: str = "auto", remat: bool | None = None
               ) -> StepBundle:
    """The sharded step of one (arch x shape) cell on ``mesh`` (module
    docstring).  Train: ``fn(params, opt_state, batch) -> (params,
    opt_state, metrics)``, the DTensor state updated in place.  Prefill:
    ``fn(params, batch) -> (logits, cache)``.  Decode: ``fn(params,
    cache, batch) -> (logits, cache)``, a new cache (the one passed in
    is left as it was).  ``batch`` holds the global inputs of
    ``input_specs`` as plain tensors on every rank; logits (the last
    position's in a prefill) and caches come back as DTensors under the
    reference's output specs.  ``bundle.specs`` holds every operand's
    spec tree, for ``distribute_tree``."""
    api = get_model(cfg)
    defs = api.param_defs(cfg)
    sizes = mesh_sizes(mesh)
    p_specs = param_pspecs(defs, plan.rules, plan.overrides,
                           axis_sizes=sizes)
    params_abs = abstract_params(defs)
    b_specs = batch_pspecs(cfg, shape, plan, sizes)
    batch_abs = input_specs(cfg, shape)
    rows = {axes_of(s[0]) for s in b_specs.values()}
    assert len(rows) == 1, b_specs
    rows = rows.pop()
    act_rules = ActivationRules(plan.act_specs, mesh, batch_axes=rows)
    splits = (cfg.family == "dense" and "model" in sizes
              and "model" not in rows)
    b_group = mesh_group(mesh, rows)
    n_rows, _ = group_size_rank(b_group)
    if remat is None:
        remat = shape.kind == "train" and cfg.n_layers >= 16
    extra = api.extra_input if api.extra_input in batch_abs else None
    specs = {"params": p_specs, "batch": b_specs}
    logits_spec = _fit((shape.global_batch, cfg.vocab), sizes,
                       plan.batch_spec[0], "model")

    def my_rows(batch):
        out = {k: local_part(v, mesh, P(b_specs[k][0]))
               for k, v in batch.items() if k in b_specs}
        if extra:
            out[extra] = out[extra].to(cfg.tdtype)
        return out

    def batch_mean(x):
        """The mean of a 0-d metric over the batch group."""
        x = x.detach().float().clone()
        if b_group is not None:
            dist.all_reduce(x, group=b_group)
            if n_rows > 1:
                x = x / n_rows
        return x

    if shape.kind == "train":
        optimizer = optimizer or AdamW()
        opt_abs = optimizer.init(params_abs)
        specs["opt_state"] = opt_state_pspecs(p_specs,
                                              optimizer.state_bits)
        shards = _walk(lambda p, spec: _leaf_shards(mesh, spec, p.numel()),
                       params_abs, p_specs)

        split = Split(cfg, mesh, p_specs) if splits else None
        # Per leaf (tree order): whether its gradient is summed over
        # "model" with the batch average (a weight kept whole there but
        # cut by a split sublayer); every other leaf's is already whole
        # on its block, equal on every "model" rank, and only averaged.
        summed = tree_leaves({
            k: ({n: split.cut_locally(n) for n in v}
                if split and k == "blocks" else _leafmap(lambda _: False, v))
            for k, v in params_abs.items()})
        groups = ((False, b_group),)
        if split:
            act_rules = ActivationRules(plan.act_specs, mesh,
                                        batch_axes=rows, split=split)
            groups += ((True, mesh_group(mesh, rows + ("model",))),)

        def grads_of(params, batch):
            """(loss, aux, grads) of the rank's rows, the gradients
            averaged over the batch group and cut to this rank's blocks:
            weight-gathered (every leaf gathered, the single-device
            forward and backward), or split over "model" (each leaf's
            "model" block as stored, gathered over its other axes)."""
            if split is None:
                full = gather_tree(params)
            else:
                full = _leafmap(lambda t: _split_block(t, mesh, rows),
                                params)
            with activation_rules(act_rules):
                loss, aux, grads = _loss_aux_grads(
                    cfg, full, my_rows(batch), impl=impl, remat=remat)
            del full

            leaves = tree_leaves(grads)
            for flag, group in groups:
                idx = [i for i, f in enumerate(summed) if f == flag]
                if group is not None and idx:
                    for i, g in zip(idx, _batch_average(
                            [leaves[i] for i in idx], group, n_rows)):
                        leaves[i] = g

            def block(g, spec):
                if split is not None:   # the dims on "model": its block
                    spec = P(*(None if e == "model" else e for e in spec))
                return local_part(g, mesh, spec).contiguous()
            return loss, aux, _walk(block, tree_unflatten(grads, leaves),
                                    p_specs)

        def train_step(params, opt_state, batch):
            loss, aux, grads = grads_of(params, batch)
            _, _, om = optimizer.update(grads, _leafmap(_local, opt_state),
                                        _leafmap(_local, params), shards)
            metrics = {"loss": batch_mean(loss), **om}
            if "imbalance_pct" in aux:
                metrics["moe_imbalance_pct"] = batch_mean(
                    aux["imbalance_pct"])
            return params, opt_state, metrics

        train_step.grads = grads_of
        return StepBundle(train_step, (params_abs, opt_abs, batch_abs),
                          specs=specs, mesh=mesh)

    cache_abs = abstract_cache(cfg, shape.global_batch, shape.seq_len)
    c_specs = cache_pspecs(cache_abs, plan, sizes)
    specs.update(cache=c_specs, logits=logits_spec)
    split = None
    if splits:
        split = Split(cfg, mesh, p_specs, c_specs["k"])
        act_rules = ActivationRules(plan.act_specs, mesh, batch_axes=rows,
                                    split=split)
    # The dims on which a split step's outputs are already the rank's
    # block: the vocab of a vocab-parallel head, the cache's KV heads or
    # head_dim.
    head_spec, vocab_dim = ((p_specs["embed"], 0) if cfg.tie_embeddings
                            else (p_specs["lm_head"], 1))
    local = {"logits": (1,) if split and head_spec[vocab_dim] == "model"
             else (),
             "kv": () if split is None else
             tuple(d for d in (2, 4) if c_specs["k"][d] == "model")}
    assert not local["logits"] or logits_spec[1] == "model", logits_spec

    def params_of(params):
        if split is None:
            return gather_tree(params)
        return _leafmap(lambda t: _split_block(t, mesh, rows), params)

    def outputs(logits, cache):
        return (_to_spec(logits, 0, rows, logits_spec, mesh,
                         local["logits"]),
                {k: _to_spec(v, 0 if k == "pos" else 1, rows, c_specs[k],
                             mesh, () if k == "pos" else local["kv"])
                 for k, v in cache.items()})

    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill_step(params, batch):
            full = params_of(params)
            b = my_rows(batch)
            kw = {extra: b[extra]} if extra else {}
            with activation_rules(act_rules):
                out = api.forward(full, b["tokens"], cfg, impl=impl,
                                  return_cache=True, return_hidden=True,
                                  cache_len=shape.seq_len, **kw)
                # head applied to the last position only -- never
                # materializes (B, S, V) logits during prefill.
                head = (full["embed"].T if cfg.tie_embeddings
                        else full["lm_head"])
                logits = out["hidden"][:, -1] @ head
            return outputs(logits, out["cache"])

        return StepBundle(prefill_step, (params_abs, batch_abs),
                          specs=specs, mesh=mesh)

    def cache_of(cache):
        if split is None:
            return {k: local_part(gather(v), mesh,
                                  P(*[None] * (k != "pos"), rows))
                    for k, v in cache.items()}
        return {k: _split_block(v, mesh, rows, 0 if k == "pos" else 1,
                                None if k == "pos" else "cache_leaf_gather")
                for k, v in cache.items()}

    @torch.no_grad()
    def serve_step(params, cache, batch):
        full = params_of(params)
        b = my_rows(batch)
        mine = cache_of(cache)
        with activation_rules(act_rules):
            logits, new = api.decode_step(full, mine, b["tokens"], cfg,
                                          impl=impl)
        return outputs(logits, new)

    return StepBundle(serve_step, (params_abs, cache_abs, batch_abs),
                      specs=specs, mesh=mesh)
