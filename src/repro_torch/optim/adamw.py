"""AdamW with optional 8-bit moment states and global-norm clipping
(counterpart of ``repro/optim/adamw.py``, same update order and
arithmetic).

Params, gradients and moments are nested dicts of tensors with the same
keys.  The 8-bit mode stores both moments as int8 with per-row f32 scales
(``Q8State``), v in the sqrt domain.  ``update`` runs under
``torch.no_grad()`` and computes the reference's arithmetic in its
order, then writes the new values into the params' and the state's own
storage (the moments' ``q`` and ``scale`` tensors when 8-bit): the
counterpart of the reference's step with donated params and state, and
what lets a captured CUDA graph replay the update.

Under a mesh (``launch/steps.py``'s sharded step) each rank updates its
own blocks of the leaves, and ``update`` takes ``shards``, a tree like
the params of ``LeafShards``: the sums that run over a whole leaf (the
global gradient norm behind ``grad_clip``, the 8-bit update's rms) are
all-reduced over the group of the ranks holding the leaf's other
blocks, and the 8-bit moments' row scale, where the leaf's last axis is
split, is the all-reduced MAX over the group that splits it, so every
number equals the reference's for the whole tensor.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from ..checkpoint.store import tree_leaves

__all__ = ["AdamW", "Q8State", "LeafShards", "quantize_state",
           "dequantize_state", "global_norm", "cosine_schedule"]


def _map(fn, *trees):
    """``fn`` over the leaves of nested dicts with the same keys."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


# Leaves of SLICE_ELEMS elements or more (an f32 copy of 2 GiB) are
# updated (and their norms summed) BLOCK_ELEMS at a time, a block of
# whole rows, so their f32 temporaries stay at 64 MB each: a 7B model's
# stacked (layers, d, ff) leaf is 4.2e9 elements, 17 GB in f32, and the
# update keeps several such temporaries.  Smaller leaves take the
# whole-leaf path, as the reference: granite's largest (4.0e8 elements)
# among them.
SLICE_ELEMS = 1 << 29
BLOCK_ELEMS = 1 << 24


def _parts(*ts):
    """Each of ``ts`` (same shape, contiguous; a ``Q8State`` as its q and
    its (..., 1) scales) cut into the same blocks of rows (every dim but
    the last flattened), or whole when small, not a matrix or not
    contiguous."""
    p = ts[-1]
    whole = [tuple(ts)]
    if p.ndim < 2 or p.numel() < SLICE_ELEMS:
        return whole
    rows, step = p.numel() // p.shape[-1], max(1, BLOCK_ELEMS // p.shape[-1])

    def flat(t):
        if isinstance(t, Q8State):
            return Q8State(flat(t.q), t.scale.reshape(rows, 1))
        return t.reshape(rows, p.shape[-1]) if t.is_contiguous() else None

    flats = [flat(t) for t in ts]
    if any(f is None or (isinstance(f, Q8State) and not (
            f.q.is_contiguous() and f.scale.is_contiguous()))
           for f in flats):
        return whole

    def cut(f, i):
        if isinstance(f, Q8State):
            return Q8State(f.q[i:i + step], f.scale[i:i + step])
        return f[i:i + step]
    return [tuple(cut(f, i) for f in flats) for i in range(0, rows, step)]


@dataclass(frozen=True)
class LeafShards:
    """How one leaf is split across ranks: ``whole`` is the group of the
    ranks that hold its other blocks (None: this rank holds all of it),
    ``last`` the group that splits its last axis, ``numel`` the whole
    leaf's element count."""
    whole: object = None
    last: object = None
    numel: int = 0


def _dict_leaves(tree) -> list:
    """The leaves of nested dicts in ``tree_leaves`` order (sorted
    keys); anything else is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _dict_leaves(tree[k])]
    return [tree]


def _all_sum(terms: list, group) -> list:
    """Each of the 0-d ``terms`` summed over ``group`` (one all-reduce)."""
    if group is None:
        return terms
    stacked = torch.stack(terms)
    dist.all_reduce(stacked, group=group)
    return list(stacked.unbind())


def global_norm(tree, shards=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32; with ``shards``
    (a tree of ``LeafShards`` like ``tree``) each leaf's sum runs over
    its blocks on every rank."""
    leaves = tree_leaves(tree)
    groups = ([None] * len(leaves) if shards is None
              else [s.whole for s in _dict_leaves(shards)])
    terms, owner = [], []
    for leaf, group in zip(leaves, groups):
        for (part,) in _parts(leaf):
            terms.append(torch.sum(torch.square(part.float())))
            owner.append(group)
    # One all-reduce per group over its leaves' sums, summed after in
    # leaf order.
    for group in {id(g): g for g in owner if g is not None}.values():
        idx = [i for i, g in enumerate(owner) if g is group]
        for i, t in zip(idx, _all_sum([terms[i] for i in idx], group)):
            terms[i] = t
    return torch.sqrt(sum(terms))


def cosine_schedule(base_lr: float, warmup: int, total: int
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up to ``base_lr``, then a cosine decay to 0 at
    ``total``; takes and returns 0-d tensors (f32 arithmetic)."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


# --- 8-bit moment storage ---------------------------------------------------------
@dataclass(frozen=True)
class Q8State:
    q: torch.Tensor          # int8
    scale: torch.Tensor      # f32, per-row (last axis reduced)


def quantize_state(x: torch.Tensor, group=None) -> Q8State:
    """int8 per row with an f32 scale; ``group`` splits the last axis
    (the row's maximum is taken over its blocks on every rank)."""
    if x.ndim == 0:
        x = x[None]
        amax = torch.max(torch.abs(x))[None]
    else:
        amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    if group is not None:
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.where(amax > 0, amax / 127.0,
                        torch.ones_like(amax)).float()
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return Q8State(q, scale)


def dequantize_state(s: Q8State) -> torch.Tensor:
    return s.q.float() * s.scale


# --- AdamW ------------------------------------------------------------------------
@dataclass(frozen=True)
class AdamW:
    lr: float | Callable = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float | None = 1.0
    state_bits: int = 32          # 32 (f32 moments) or 8 (int8 + scales)

    def init(self, params) -> dict:
        def zero(p):
            if self.state_bits != 8:
                return torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
            # quantize_state of zeros, made without the f32 zeros: q 0
            # and a scale of 1 per row (per the (1,) row of a scalar).
            rows = tuple(p.shape[:-1]) + (1,) if p.ndim else (1,)
            return Q8State(
                torch.zeros(p.shape if p.ndim else (1,), dtype=torch.int8,
                            device=p.device),
                torch.ones(rows, dtype=torch.float32, device=p.device))
        step_device = tree_leaves(params)[0].device
        return {
            "m": _map(zero, params),
            # v is stored in the sqrt domain when quantized: int8's 1/127
            # relative floor is far too coarse for v directly.
            "v": _map(zero, params),
            "step": torch.zeros((), dtype=torch.int32, device=step_device),
        }

    def _lr(self, step):
        if callable(self.lr):
            return self.lr(step)
        # A fill on the device, not a copy from the host: capturable.
        return torch.full((), self.lr, dtype=torch.float32,
                          device=step.device)

    @torch.no_grad()
    def update(self, grads, state, params, shards=None):
        """Updates ``params`` and ``state`` in place; returns (params,
        state, metrics).  ``shards``: a tree of ``LeafShards`` like the
        params when each holds this rank's blocks (module docstring)."""
        step = state["step"] + 1
        gnorm = (global_norm(grads) if shards is None
                 else global_norm(grads, shards))
        clip = None
        if self.grad_clip is not None:
            clip = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        lr = self._lr(step)
        b1, b2 = self.b1, self.b2
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()

        def moments(g, m, v):
            """(m_new, v_new, delta) of one block of a leaf, in f32."""
            g = g.float()
            if clip is not None:
                g = g * clip
            if self.state_bits == 8:
                mf = dequantize_state(m)
                vf = torch.square(dequantize_state(v))   # sqrt-domain store
                if g.ndim == 0:
                    mf, vf = mf[0], vf[0]
            else:
                mf, vf = m, v
            m_new = b1 * mf + (1 - b1) * g
            v_new = b2 * vf + (1 - b2) * g * g
            mhat = m_new / c1
            vhat = v_new / c2
            return m_new, v_new, mhat / (torch.sqrt(vhat) + self.eps)

        def upd(g, m, v, p, sh):
            parts = _parts(g, m, v, p)
            rms = whole = None
            if len(parts) == 1:
                whole = moments(g, m, v)
            if self.state_bits == 8:
                # Adafactor-style update clipping, as the reference: the
                # rms of the whole leaf's update (a first pass over its
                # blocks when it is cut).
                if whole is not None and sh.whole is None:
                    rms = torch.sqrt(torch.mean(torch.square(whole[2]))
                                     + 1e-30)
                else:
                    ss = sum(torch.sum(torch.square(
                        (whole or moments(*part[:3]))[2])) for part in parts)
                    ss, = _all_sum([ss], sh.whole)
                    rms = torch.sqrt(ss / (sh.numel or p.numel()) + 1e-30)
            for g_, m_, v_, p_ in parts:
                m_new, v_new, delta = whole or moments(g_, m_, v_)
                if rms is not None:
                    delta = delta / torch.clamp(rms, min=1.0)
                if p.ndim >= 2:   # decoupled weight decay on matrices only
                    delta = delta + self.weight_decay * p_.float()
                p_new = (p_.float() - lr * delta).to(p_.dtype)
                if self.state_bits == 8:
                    m_new = quantize_state(m_new, sh.last)
                    v_new = quantize_state(torch.sqrt(v_new), sh.last)
                p_.copy_(p_new)
                for old, new in ((m_, m_new), (v_, v_new)):
                    if self.state_bits == 8:
                        old.q.copy_(new.q)
                        old.scale.copy_(new.scale)
                    else:
                        old.copy_(new)

        if shards is None:
            shards = _map(lambda p: LeafShards(), params)
        _map(upd, grads, state["m"], state["v"], params, shards)
        state["step"].copy_(step)
        return params, state, {"grad_norm": gnorm, "lr": lr}
