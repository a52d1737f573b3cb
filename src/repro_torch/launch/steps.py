"""The training step (counterpart of the single-device body of
``repro/launch/steps.py::build_step``, lines 213-248).

One step, for every family: the family's legacy forward
(``get_model(cfg).forward``, with the batch's extra input --
``vision_embeds`` for the vlm, ``encoder_frames`` for audio -- where the
family names one) with ``return_hidden`` (remat by default from 16
layers on, as the reference), the chunked cross-entropy against
the head (``embed.T`` when the embeddings are tied) plus
``AUX_LOSS_WEIGHT`` times the MoE layers' load-balance loss, gradients
by autograd, then the AdamW update.  The mesh, the sharding trees and
the prefill / decode builders are multi-device work (ROADMAP A.12).

The reference jits the step and donates the params and the optimizer
state.  Here the step updates both in place (``AdamW.update``), and on
the card it runs off a CUDA graph through the executor's ``GraphStore``:
the first call runs eagerly and is the real first step, the second is
captured and replayed, later ones replay.  The batch is copied into the
graph's static inputs (the extra input beside the tokens and labels),
the gradients live in its memory pool, and the metrics are cloned out
after each replay.  The graph is keyed on the batch shapes and the
addresses of the params and state it was captured
on, so state that comes back from a checkpoint as new tensors gets a
graph of its own (the step keeps one).  On the CPU, and inside
``executor.disable_graphs()``, every call runs eagerly.
"""
from __future__ import annotations

import torch

from ..checkpoint.store import tree_leaves, tree_unflatten
from ..configs.base import ArchConfig
from ..models import get_model
from ..models.losses import chunked_cross_entropy
from ..optim import AdamW
from ..runtime import executor

__all__ = ["AUX_LOSS_WEIGHT", "loss_and_grads", "build_train_step",
           "step_key"]

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
    with torch.enable_grad():
        out = api.forward(p, batch["tokens"], cfg, impl=impl, remat=remat,
                          return_hidden=True, **kw)
        head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
        loss = chunked_cross_entropy(out["hidden"], head, batch["labels"])
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
