"""The training step (counterpart of the single-device body of
``repro/launch/steps.py::build_step``, lines 199-225).

One step: the legacy forward with ``return_hidden`` (remat by default
from 16 layers on, as the reference), the chunked cross-entropy against
the head (``embed.T`` when the embeddings are tied), gradients by
autograd, then ``AdamW.update``.  The mesh, the sharding trees and the
prefill / decode builders are multi-device work (ROADMAP A.12); the MoE
load-balance term comes with the MoE family (A.9).
"""
from __future__ import annotations

import torch

from ..checkpoint.store import tree_leaves, tree_unflatten
from ..configs.base import ArchConfig
from ..models import transformer
from ..models.losses import chunked_cross_entropy
from ..optim import AdamW

__all__ = ["loss_and_grads", "build_train_step"]


def loss_and_grads(cfg: ArchConfig, params, batch, *, impl: str = "auto",
                   remat: bool = False):
    """(loss, grads): the mean token CE of one batch and its gradient in
    every parameter, a tree like ``params``."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    p = tree_unflatten(params, leaves)
    with torch.enable_grad():
        out = transformer.forward(p, batch["tokens"], cfg, impl=impl,
                                  remat=remat, return_hidden=True)
        head = p["embed"].T if cfg.tie_embeddings else p["lm_head"]
        loss = chunked_cross_entropy(out["hidden"], head, batch["labels"])
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def build_train_step(cfg: ArchConfig, optimizer: AdamW | None = None, *,
                     impl: str = "auto", remat: bool | None = None):
    """The step (params, opt_state, batch) -> (params, opt_state,
    metrics); ``batch`` holds "tokens" and "labels" (B, S) on the
    parameters' device."""
    optimizer = optimizer or AdamW()
    if remat is None:
        remat = cfg.n_layers >= 16

    def train_step(params, opt_state, batch):
        loss, grads = loss_and_grads(cfg, params, batch, impl=impl,
                                     remat=remat)
        params, opt_state, om = optimizer.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **om}
    return train_step
