"""Model substrate: parameter definition trees, init, the weight bridge
from ``repro``, and the norms and rotary embedding the LM ops use
(counterpart of ``repro/models/common.py``).

Parameters are declared as ``ParamDef`` trees (shape + dtype + logical
axes + init kind) and initialised from a ``torch.Generator``.  The same
seed gives other numbers than ``repro``'s ``jax.random`` init, so
parity checks hand both packages the same arrays: ``params_from_numpy``
turns ``repro``'s parameter tree, taken as numpy arrays, into this
package's tree with the same keys, shapes, layouts and dtypes, and
never re-initialises anything.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..parallel.act_sharding import P

__all__ = ["ParamDef", "init_params", "tree_paths", "params_from_numpy",
           "abstract_params", "param_pspecs", "rms_norm", "layer_norm", "Rotary", "apply_rope",
           "cross_entropy_loss"]


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[Any, ...]                 # logical axis names (or None)
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                  # normal | zeros | ones | embed
    init_scale: float | None = None       # overrides fan-in scaling

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_paths(defs: dict, prefix: str = "") -> list[str]:
    out = []
    for k, v in defs.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.extend(tree_paths(v, p))
        else:
            out.append(p)
    return out


def _init_leaf(d: ParamDef, generator: torch.Generator,
               device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "embed":
        scale = d.init_scale if d.init_scale is not None else 0.02
    else:
        # fan-in scaled normal; stacked layer axes excluded from fan-in.
        fan_shape = (d.shape[1:] if (d.axes and d.axes[0] == "layers")
                     else d.shape)
        fan = math.prod(fan_shape[:-1]) if len(fan_shape) > 1 else fan_shape[0]
        scale = d.init_scale if d.init_scale is not None else fan ** -0.5
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(d.dtype)


def init_params(defs: dict, generator: torch.Generator,
                device=None) -> dict:
    """Initialise a ParamDef tree to tensors on ``device`` (the
    generator's device by default), drawing leaves in ``tree_paths``
    order from ``generator``."""
    device = generator.device if device is None else device

    def go(sub: dict) -> dict:
        return {k: go(v) if isinstance(v, dict)
                else _init_leaf(v, generator, device)
                for k, v in sub.items()}
    return go(defs)


def abstract_params(defs: dict) -> dict:
    """The tree of parameters on the ``meta`` device: shapes and dtypes,
    no storage (the reference's ShapeDtypeStruct tree)."""
    return {k: abstract_params(v) if isinstance(v, dict)
            else torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in defs.items()}


def param_pspecs(defs: dict, rules: dict,
                 overrides: dict | None = None,
                 axis_sizes: dict | None = None) -> dict:
    """Map logical axes -> mesh axes (rules values: None, str, or tuple).

    A mesh axis may appear only once per tensor; when two logical axes
    map to the same mesh axis, the earlier tensor axis wins (e.g. MoE
    weights (experts, embed, ff) with experts->model keep ff unsharded).
    Entries whose dimension is not divisible by the mesh-axis size are
    dropped (every shard the same size).  ``overrides``: path-suffix ->
    rules dict, for per-layer-class strategies chosen by the distributed
    Mloop/Kloop cost model; the longest matching suffix wins.
    """
    def spec(d: ParamDef, ruleset: dict) -> P:
        entries = []
        used: set[str] = set()
        for ax, dim in zip(d.axes, d.shape):
            r = ruleset.get(ax) if ax is not None else None
            names = (r,) if isinstance(r, str) else tuple(r or ())
            if axis_sizes is not None and names:
                total = 1
                for n in names:
                    total *= axis_sizes.get(n, 1)
                if total and dim % total != 0:
                    r, names = None, ()
            if any(n in used for n in names):
                r = None
            else:
                used.update(names)
            entries.append(r)
        return P(*entries)

    def pick_rules(path: str) -> dict:
        best = None
        for suffix, rs in (overrides or {}).items():
            if path.endswith(suffix) and (best is None
                                          or len(suffix) > len(best[0])):
                best = (suffix, rs)
        return rules if best is None else best[1]

    def go(sub, prefix=""):
        out = {}
        for k, v in sub.items():
            p = f"{prefix}/{k}" if prefix else k
            out[k] = (go(v, p) if isinstance(v, dict)
                      else spec(v, pick_rules(p)))
        return out
    return go(defs)


def params_from_numpy(tree: dict, device="cpu") -> dict:
    """The weight bridge: a nested dict of arrays (``repro``'s params
    after ``np.asarray``) as the same tree of tensors on ``device``.
    Keys, shapes and layouts are kept; float32/bfloat16 keep their
    dtype (bfloat16 arrays arrive as ml_dtypes and are widened through
    float32 on the way).  Every leaf is a copy: the training step
    updates its params in place, which must not write into the
    caller's arrays."""
    def leaf(a) -> torch.Tensor:
        arr = np.asarray(a)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(arr)).to(device)

    return {k: params_from_numpy(v, device) if isinstance(v, dict)
            else leaf(v) for k, v in tree.items()}


# --- norms and rotary: f32 math, cast back, in the reference's order ----------
def rms_norm(x: torch.Tensor, weight: torch.Tensor | None,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, weight=None, bias=None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm; with weight=bias=None this is OLMo's non-parametric LN."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


@dataclass(frozen=True)
class Rotary:
    head_dim: int
    theta: float = 10000.0

    def freqs(self, positions: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """positions: (...,) int -> (cos, sin) of shape (..., head_dim/2),
        on the positions' device."""
        half = self.head_dim // 2
        exps = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
        inv = torch.pow(self.theta, exps)
        ang = positions.float()[..., None] * inv
        return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, D); cos/sin: (S, D/2) or broadcastable."""
    x1, x2 = x.float().chunk(2, dim=-1)
    while cos.ndim < x1.ndim:
        cos, sin = cos[None], sin[None]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# --- loss ---------------------------------------------------------------------
def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token CE.  logits (B, L, V) f32-upcast; labels (B, L)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
