"""The split execution of the dense family's sharded train, prefill and
decode steps over "model" (the reference's GSPMD partition of the
``tp`` and ``mixed`` layouts' activation-gathered classes).

``launch/steps.py::build_step`` installs a ``Split`` in the
``activation_rules`` context of a dense step whose rows do not lie on
"model"; the models reach it through the hooks below, each the
identity outside a split:

* ``Split.proj(x, w, name)`` (through ``models/transformer.py``'s
  ``_proj``) -- a block projection ``x @ w``.  Each weight
  follows its spec (read from the plan, never inferred from shapes):
  column (the N dim on "model": wq, wk, wv, w_gate, w_up) gives the
  rank's columns with no communication; row (the K dim on "model": wo,
  w_down) multiplies the rank's slice of ``x``'s last dim by its block
  of rows and all-reduces the partial sums over "model".  A weight the
  plan keeps whole along "model" is cut to the rank's columns or rows
  locally, so attention and the MLP split as soon as one of their
  weights is on "model"; where none is, they run as on one device.  A
  split sublayer's output is always one all-reduce of the ranks'
  partial sums, so its backward is split too.
* ``enter(x, sublayer)`` -- a split sublayer's input ("attn" or "mlp",
  at the top of ``_attention`` and ``_mlp``): under autograd the
  "to model" function (identity forward, all-reduce backward) sums the
  ranks' partial gradients of ``x``, once a sublayer.
* ``local_heads(H, KV, kind)`` -- the (query, KV) heads the rank's flash
  or decode launch sees, by ``head_case``: the rank's H/g query heads
  and KV/g KV heads ("whole"); its H/g query heads and the one KV head
  they read, whose K/V columns g/KV ranks compute alike ("shared_kv");
  every head, the attention weights gathered over "model" and attention
  run duplicated, where a block would cut a head ("cut"); every head as
  on one device where the plan splits no attention weight ("unsplit").
  Each call is counted in ``COUNTS``.
* ``embed_rows(embed, tokens)`` -- the embedding lookup; a vocab-split
  table masks the tokens outside the rank's rows and all-reduces.  The
  head needs no hook: ``h @ block`` is the rank's V/g logits columns
  (training: ``models/losses.py``'s vocab-parallel cross-entropy over
  ``Split.head_group``).
* ``kv_block`` (prefill), ``kv_view`` / ``kv_store`` (decode) -- the
  cache kept in its blocks: with the KV heads on "model" a rank writes
  and reads its own heads; with head_dim on "model" (KV < g) it
  exchanges, a layer at a time, only the head_dim blocks of the head it
  reads (one all-to-all), and the new rows of every head (one
  all-gather of a row a sequence).

Under autograd (the train step) every collective is a
``torch.autograd.Function`` (Megatron's pair and a gather):
``to_model`` (identity, all-reduce backward), ``from_model`` (all-reduce,
identity backward: the row projections, the vocab-split embedding's and
cross-entropy's sums) and the gather of a weight's columns over "model"
or a run of its ranks, whose backward reduce-scatters (sums) the
gradient to the rank's block; each counts its calls in ``COUNTS``,
forward and backward apart.  Under ``torch.no_grad()`` (serving) they
count nothing new.  The gradients come out as the rank's blocks; a leaf
the plan keeps whole along "model" but a split sublayer cuts locally
holds only its rank's part of its gradient (``cut_locally``), which the
step sums over "model".

Collectives go to the "model" group (none at a group of one), so on a
world of one the split path is the single-device computation bit for
bit.  The other families run weight-gathered (``launch/steps.py``).
"""
from __future__ import annotations

from collections import Counter

import torch
import torch.distributed as dist

from .act_sharding import P, current_rules
from .placement import group_size_rank, mesh_group, mesh_subgroup

__all__ = ["COUNTS", "HEAD_CASES", "Split", "head_case", "model_dim",
           "to_model", "from_model", "model_max", "gather_columns",
           "active", "enter", "local_heads", "embed_rows", "kv_block",
           "kv_view", "kv_store"]

HEAD_CASES = ("whole", "shared_kv", "cut", "unsplit")
COLUMN = ("wq", "wk", "wv", "w_gate", "w_up")
ROW = ("wo", "w_down")
ATTN = ("wq", "wk", "wv", "wo")
MLP = ("w_gate", "w_up", "w_down")

# What the split did, per rank since the last ``COUNTS.clear()``:
# "flash:<case>:<q heads>/<kv heads>" and "decode:..." a layer each,
# "model_gather:<weight>" per weight gathered over "model", and for the
# cache "kv_exchange" (the head_dim blocks of one head, a layer),
# "kv_layer_gather" (a whole layer: the cut case, or one KV head) and
# "cache_leaf_gather" (a cache leaf gathered before the step, counted by
# ``launch/steps.py``: only where the cache spec spreads the KV heads over
# ("data", "model"), a batch "data" does not divide).  Under autograd
# (the train step) also "model_all_reduce:fwd" (an all-reduce a forward
# issues: a row projection, the vocab-split embedding, the vocab-parallel
# cross-entropy's max, sum and gold logit; a recompute under
# ``torch.utils.checkpoint`` issues again those before the last tensor
# the backward needs, where it stops), "model_all_reduce:bwd" (the "to
# model" all-reduce of a gradient) and "model_reduce_scatter:<weight>"
# (a gather's backward).
COUNTS: Counter = Counter()


def _size(group) -> int:
    return group_size_rank(group)[0]


class _ToModel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        COUNTS["model_all_reduce:bwd"] += 1
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _FromModel(torch.autograd.Function):
    """All-reduce (sum) over ``group`` in place; identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        dist.all_reduce(x, group=group)
        ctx.mark_dirty(x)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherColumns(torch.autograd.Function):
    """The blocks of ``w`` on every rank of ``group`` laid end to end
    along the last dim; the gradient reduce-scattered (summed) back to
    this rank's block."""

    @staticmethod
    def forward(ctx, w, group, name):
        ctx.group, ctx.name = group, name
        parts = [torch.empty_like(w) for _ in range(_size(group))]
        dist.all_gather(parts, w.contiguous(), group=group)
        return torch.cat(parts, -1)

    @staticmethod
    def backward(ctx, grad):
        k = _size(ctx.group)
        out = torch.empty((*grad.shape[:-1], grad.shape[-1] // k),
                          dtype=grad.dtype, device=grad.device)
        COUNTS["model_reduce_scatter:" + ctx.name] += 1
        dist.reduce_scatter(out, [c.contiguous() for c in grad.chunk(k, -1)],
                            group=ctx.group)
        return out, None, None


def to_model(x, group):
    """``x`` as it is; under autograd its gradient is summed over
    ``group`` (Megatron's "f").  The identity at a group of one."""
    if _size(group) == 1 or not torch.is_grad_enabled():
        return x
    return _ToModel.apply(x, group)


def from_model(x, group):
    """``x`` summed over ``group`` in place (Megatron's "g"), the
    gradient passed through as it is; counted under autograd.  The
    identity at a group of one."""
    if _size(group) == 1:
        return x
    if torch.is_grad_enabled():
        COUNTS["model_all_reduce:fwd"] += 1
    return _FromModel.apply(x.contiguous(), group)


def model_max(x, group):
    """``x`` (no gradient) all-reduced MAX over ``group``, in place;
    counted under autograd, as ``from_model``."""
    if _size(group) > 1:
        if torch.is_grad_enabled():
            COUNTS["model_all_reduce:fwd"] += 1
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def gather_columns(w, group, name: str):
    """The blocks of ``w`` over ``group`` laid end to end along the last
    dim; under autograd the gradient is reduce-scattered back.  The
    identity at a group of one."""
    return w if _size(group) == 1 else _GatherColumns.apply(w, group, name)


def head_case(H: int, KV: int, hd: int, g: int) -> str:
    """How g "model" ranks split attention with H query heads of hd and
    KV KV heads (``HEAD_CASES``): "whole" where both head counts divide
    g; "shared_kv" where H does and each KV head serves g / KV ranks;
    "cut" where a block of the H * hd columns would cut a head (the
    columns are gathered, attention runs duplicated); "unsplit" where
    g does not divide H * hd, so no spec puts those columns on
    "model"."""
    if H % g == 0 and KV % g == 0:
        return "whole"
    if H % g == 0 and KV < g and g % KV == 0:
        return "shared_kv"
    if (H * hd) % g == 0:
        return "cut"
    return "unsplit"


def model_dim(spec) -> int | None:
    """The dim a spec puts on "model" alone, or None."""
    for d, e in enumerate(spec):
        if e == "model":
            return d
    return None


class Split:
    """One dense step's split over "model" (module docstring): ``specs``
    is the step's parameter spec tree, ``kv_spec`` the K / V cache
    leaves' spec (None for a train step, which has no cache)."""

    def __init__(self, cfg, mesh, specs: dict, kv_spec: P | None = None):
        self.group = mesh_group(mesh, "model")
        self.g, self.r = group_size_rank(self.group)
        H, KV, hd, F, g, r = (cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                              cfg.d_ff, self.g, self.r)
        self.hd = hd
        # the dim of each (layer-axis-less) block weight on "model"
        self.on = {k: model_dim(specs["blocks"][k][1:])
                   for k in COLUMN + ROW}
        attn = any(self.on[k] is not None for k in ATTN)
        self.case = head_case(H, KV, hd, g) if attn else "unsplit"
        self.ff = any(self.on[k] is not None for k in MLP)
        self.vocab = model_dim(specs["embed"]) == 0
        # The group the head's vocab columns are split over, or None.
        head_split = (self.vocab if cfg.tie_embeddings
                      else model_dim(specs["lm_head"]) == 1)
        self.head_group = self.group if head_split and self.g > 1 else None
        self.mesh, self.KV = mesh, KV
        self.q = q = ((r * H // g, H // g)
                      if self.case in ("whole", "shared_kv") else (0, H))
        self.kv = kv = self._held(r)
        # The rank's (start, size) of each column weight's columns (a
        # row weight's rows are its block of g: ``proj``).
        fs = (r * F // g, F // g) if self.ff else (0, F)
        self.span = {"wq": (q[0] * hd, q[1] * hd),
                     "wk": (kv[0] * hd, kv[1] * hd),
                     "wv": (kv[0] * hd, kv[1] * hd),
                     "w_gate": fs, "w_up": fs}
        if self.case == "shared_kv":
            # made now, by every rank in one order: the ranks sharing a
            # KV head gather its K / V columns
            mesh_subgroup(mesh, "model", KV)
        self.layout = (None if kv_spec is None else
                       "heads" if kv_spec[2] == "model" else
                       "hd" if kv_spec[4] == "model" else "whole")
        # The chunks an exchange returns hold each rank's held heads in
        # rank order; every step-th is a head's first holder.
        self.step = g * kv[1] // KV

    def _held(self, rank: int) -> tuple[int, int]:
        """(first, count) of the KV heads ``rank`` computes."""
        KV, g = self.KV, self.g
        if self.case == "whole":
            return rank * KV // g, KV // g
        if self.case == "shared_kv":
            return rank // (g // KV), 1
        return 0, KV

    def _active(self, name: str) -> bool:
        return self.case != "unsplit" if name in ATTN else self.ff

    def cut_locally(self, name: str) -> bool:
        """Whether the block weight ``name`` is kept whole along "model"
        and used by a split sublayer: each rank's gradient then holds
        only its part, to be summed over "model"."""
        return (name in self.on and self.on[name] is None
                and self._active(name))

    def enter(self, x, sublayer: str):
        """A sublayer's input ("attn" or "mlp"): through ``to_model``
        where the sublayer is split."""
        split = self.case != "unsplit" if sublayer == "attn" else self.ff
        return to_model(x, self.group) if split else x

    def _all_reduce(self, t):
        return from_model(t, self.group)

    def _columns(self, w, name: str, start: int, n: int):
        """Columns [start, start + n) of the whole weight: the rank's
        block, its block gathered over the ranks whose blocks make the
        range, or a local cut of a weight kept whole along "model"."""
        if self.on[name] != w.ndim - 1:
            return w.narrow(-1, start, n)
        b = w.shape[-1]
        if n == b:
            return w
        COUNTS["model_gather:" + name] += 1
        parts = self.g * b // n
        group = (self.group if parts == 1 else
                 mesh_subgroup(self.mesh, "model", parts))
        return gather_columns(w, group, name)

    def proj(self, x, w, name: str):
        if not self._active(name):
            return x @ w
        if name in COLUMN:
            return x @ self._columns(w, name, *self.span[name])
        # A row weight: the rank's block of rows, its own (w on "model")
        # or cut from a whole one, against the same slice of x (x holds
        # every column in the cut case, else the rank's part).
        b = w.shape[0] * (self.g if self.on[name] == 0 else 1) // self.g
        if x.shape[-1] != b:
            x = x.narrow(-1, self.r * b, b)
        if w.shape[0] != b:
            w = w.narrow(0, self.r * b, b)
        return self._all_reduce(x @ w)

    def local_heads(self, kind: str) -> tuple[int, int]:
        heads = (self.q[1], self.kv[1])
        COUNTS[f"{kind}:{self.case}:{heads[0]}/{heads[1]}"] += 1
        return heads

    def embed_rows(self, embed, tokens):
        if not self.vocab or self.g == 1:
            return embed[tokens.long()]
        n = embed.shape[0]
        t = tokens.long() - self.r * n
        inside = (t >= 0) & (t < n)
        h = torch.where(inside[..., None], embed[t.clamp(0, n - 1)],
                        torch.zeros((), dtype=embed.dtype,
                                    device=embed.device))
        return self._all_reduce(h)

    # --- the cache in its blocks -------------------------------------------
    def _holds_all(self) -> bool:
        return self.kv[1] == self.KV

    def _owners(self, chunks):
        """(g, B, held, ...) chunks of every rank -> (B, KV, ...): each
        head from its first holder."""
        g, B, n = chunks.shape[:3]
        t = chunks.movedim(0, 1).reshape(B, g * n, *chunks.shape[3:])
        return t if self.step == 1 else t[:, ::self.step]

    def _gather(self, t, dim: int = 0):
        parts = [torch.empty_like(t) for _ in range(self.g)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.stack(parts) if dim is None else torch.cat(parts, dim)

    def _a2a(self, chunks):
        out = torch.empty_like(chunks)
        dist.all_to_all_single(out, chunks.contiguous(), group=self.group)
        return out

    def kv_block(self, k):
        """Prefill: the rank's held heads' (B, held, S, hd) K or V as
        the cache's block of this layer."""
        if self.g == 1:
            return k
        g, r, d = self.g, self.r, self.hd // self.g
        if self.layout == "heads":
            n = self.KV // g
            return k if not self._holds_all() else k.narrow(1, r * n, n)
        if self._holds_all():
            return k.narrow(-1, r * d, d) if self.layout == "hd" else k
        if self.layout == "hd":
            COUNTS["kv_exchange"] += 1
            return self._owners(self._a2a(torch.stack(k.split(d, -1))))
        return self._owners(self._gather(k, None))

    def kv_view(self, ck):
        """Decode: this layer's (B, held, S, hd) K or V of the rank's
        held heads, from its stored block."""
        if self.g == 1:
            return ck
        g, r = self.g, self.r
        if self.layout == "heads":
            if not self._holds_all():
                return ck
            COUNTS["kv_layer_gather"] += 1
            return self._gather(ck, 1)
        if self.layout == "whole":
            return ck.narrow(1, *self.kv)
        if self._holds_all():
            COUNTS["kv_layer_gather"] += 1
            return self._gather(ck, -1)
        COUNTS["kv_exchange"] += 1
        sends = torch.stack([ck.narrow(1, *self._held(j))
                             for j in range(g)])
        got = self._a2a(sends)                   # (g, B, held, S, hd / g)
        return got.permute(1, 2, 3, 0, 4).reshape(*got.shape[1:4], -1)

    def kv_store(self, ck, view, new, slot):
        """Decode: the stored block of this layer after the step: ``view``
        (the held heads with their new row at ``slot``) cut to the block,
        or, where the block holds heads the rank did not compute, ``ck``
        with every head's new row (one all-gather of (B, held, hd))."""
        if self.g == 1:
            return view
        g, r, d = self.g, self.r, self.hd // self.g
        if self.layout == "heads":
            n = self.KV // g
            return view if not self._holds_all() else view.narrow(1, r * n, n)
        if self._holds_all():
            return view.narrow(-1, r * d, d) if self.layout == "hd" else view
        rows = self._owners(self._gather(new, None))      # (B, KV, hd)
        if self.layout == "hd":
            rows = rows.narrow(-1, r * d, d)
        idx = slot.long()[:, None, None, None].expand(-1, rows.shape[1], 1,
                                                      rows.shape[2])
        return ck.scatter(2, idx, rows[:, :, None].to(ck.dtype))


# --- the hooks the models call ---------------------------------------
def active() -> Split | None:
    """The split of the step running in this context, if any."""
    rules = current_rules()
    return None if rules is None else rules.split


def enter(x, sublayer: str):
    """A sublayer's input ("attn" or "mlp"), as it is outside a split."""
    sp = active()
    return x if sp is None else sp.enter(x, sublayer)


def local_heads(H: int, KV: int, kind: str) -> tuple[int, int]:
    """(query heads, KV heads) of this rank's ``kind`` ("flash" or
    "decode") attention launch: (H, KV) outside a split."""
    sp = active()
    return (H, KV) if sp is None else sp.local_heads(kind)


def embed_rows(embed, tokens):
    """``embed[tokens]``, whole rows of the whole vocab."""
    sp = active()
    return embed[tokens.long()] if sp is None else sp.embed_rows(embed,
                                                                 tokens)


def kv_block(k):
    sp = active()
    return k if sp is None else sp.kv_block(k)


def kv_view(ck):
    sp = active()
    return ck if sp is None else sp.kv_view(ck)


def kv_store(ck, view, new, slot):
    sp = active()
    return view if sp is None else sp.kv_store(ck, view, new, slot)
