"""Layer-graph IR — the compiler's planning substrate (paper §5.1, T1).

The paper's compiler parses a Torch7 model into a doubly-linked list of
layer objects (step 1), then scans for non-sequential inter-layer
relations — residual/parallel paths — and attaches *dependency labels*
(step 2) that drive memory-region allocation and the fused bypass add.

This module is the JAX analogue: model configs are lowered into a
``ModelGraph`` of ``LayerNode``s.  Each node carries a workload
descriptor (enough to compute FLOPs / bytes / tile shapes), a dependency
label, and an optional ``bypass_of`` back-reference (the paper's
residual-add-on-writeback).  The schedule compiler (core/schedule.py)
consumes this graph; the models themselves execute separately and are
*parameterized* by the resulting schedule.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Iterator

__all__ = [
    "LayerKind",
    "DepLabel",
    "LayerNode",
    "ModelGraph",
    "matmul_node",
    "conv_node",
    "attention_node",
    "decode_attention_node",
    "cross_attention_node",
    "ssm_scan_node",
    "wkv_node",
    "moe_node",
    "norm_node",
    "embed_node",
    "elementwise_node",
    "pool_out",
    "kernel_kind",
]


class LayerKind(enum.Enum):
    MATMUL = "matmul"          # any dense projection (QKV, O, FFN, FC, lm head)
    CONV2D = "conv2d"          # the paper's own workloads
    ATTENTION = "attention"    # softmax attention (flash kernel)
    SSM_SCAN = "ssm_scan"      # Mamba2 chunked scan
    WKV = "wkv"                # RWKV6 recurrence
    MOE = "moe"                # expert-parallel grouped matmul
    NORM = "norm"
    EMBED = "embed"
    POOL = "pool"              # max/avg pool (paper's Maxpool/Avgpool)
    ELEMENTWISE = "elementwise"


class DepLabel(enum.Enum):
    """Paper §5.1 step 2: how a layer relates to its neighbours.

    SEQUENTIAL       — input comes only from the previous layer.
    RESIDUAL_SOURCE  — output is additionally consumed by a later bypass.
    RESIDUAL_SINK    — consumes a bypass; the add is fused into this
                       layer's writeback (paper: VMOV per write-back MAC).
    PARALLEL         — one of several layers sharing an input (GoogLeNet-
                       style branches; cross-attn streams in the VLM).
    """

    SEQUENTIAL = "sequential"
    RESIDUAL_SOURCE = "residual_source"
    RESIDUAL_SINK = "residual_sink"
    PARALLEL = "parallel"


@dataclass
class LayerNode:
    name: str
    kind: LayerKind
    # Workload descriptor.  Keys by kind:
    #   MATMUL: M, K, N                       (+ optional "groups" for GQA KV)
    #   CONV2D: H, W, C_in, C_out, kh, kw, stride, pad, batch
    #   ATTENTION: seq_q, seq_kv, heads, kv_heads, head_dim, batch, causal
    #   SSM_SCAN: seq, heads, head_dim, state, batch
    #   WKV: seq, heads, head_dim, batch
    #   MOE: M (tokens), K, N, experts, top_k
    #   NORM/ELEMENTWISE/POOL/EMBED: numel (+ EMBED: vocab, d_model)
    dims: dict = field(default_factory=dict)
    dtype_bytes: int = 2
    inputs: list[str] = field(default_factory=list)
    dep: DepLabel = DepLabel.SEQUENTIAL
    bypass_of: str | None = None   # residual source this sink adds on writeback
    # Epilogue ops fused into the producing kernel (paper's bias VMOV / ReLU).
    fused_bias: bool = False
    fused_activation: str | None = None  # "relu" | "silu" | "gelu" | None
    meta: dict = field(default_factory=dict)

    # --- workload accounting --------------------------------------------------
    def flops(self) -> float:
        d = self.dims
        k = self.kind
        if k is LayerKind.MATMUL:
            return 2.0 * d["M"] * d["K"] * d["N"]
        if k is LayerKind.CONV2D:
            oh = _conv_out(d["H"], d["kh"], d["stride"], d["pad"])
            ow = _conv_out(d["W"], d["kw"], d["stride"], d["pad"])
            return (2.0 * d.get("batch", 1) * oh * ow * d["C_out"]
                    * d["C_in"] * d["kh"] * d["kw"])
        if k is LayerKind.ATTENTION:
            b, h, hd = d["batch"], d["heads"], d["head_dim"]
            sq, skv = d["seq_q"], d["seq_kv"]
            causal = 0.5 if d.get("causal") and sq == skv else 1.0
            return 2.0 * 2.0 * b * h * sq * skv * hd * causal  # QK^T + PV
        if k is LayerKind.SSM_SCAN:
            b, h, hd, st = d["batch"], d["heads"], d["head_dim"], d["state"]
            return 2.0 * 3.0 * b * d["seq"] * h * hd * st      # dA, B-outer, C-contract
        if k is LayerKind.WKV:
            b, h, hd = d["batch"], d["heads"], d["head_dim"]
            return 2.0 * 2.0 * b * d["seq"] * h * hd * hd       # state update + readout
        if k is LayerKind.MOE:
            return 2.0 * d["M"] * d["K"] * d["N"] * d["top_k"]
        if k is LayerKind.EMBED:
            return 0.0
        return float(d.get("numel", 0))  # ~1 FLOP/elem for norms/elementwise

    def operand_bytes(self) -> dict[str, float]:
        """Minimum off-chip bytes per operand class (each element once)."""
        d, k = self.dims, self.kind
        by = self.dtype_bytes
        if k is LayerKind.MATMUL:
            return {"maps": d["M"] * d["K"] * by,
                    "weights": d["K"] * d["N"] * by,
                    "out": d["M"] * d["N"] * by}
        if k is LayerKind.CONV2D:
            oh = _conv_out(d["H"], d["kh"], d["stride"], d["pad"])
            ow = _conv_out(d["W"], d["kw"], d["stride"], d["pad"])
            b = d.get("batch", 1)
            return {"maps": b * d["H"] * d["W"] * d["C_in"] * by,
                    "weights": d["C_in"] * d["kh"] * d["kw"] * d["C_out"] * by,
                    "out": b * oh * ow * d["C_out"] * by}
        if k is LayerKind.MOE:
            return {"maps": d["M"] * d["K"] * by * d["top_k"],
                    "weights": d["experts"] * d["K"] * d["N"] * by,
                    "out": d["M"] * d["N"] * by * d["top_k"]}
        if k is LayerKind.SSM_SCAN:
            # Coarse Mamba2 block: h/x/dt/B/C streams in, h' out, plus
            # the recurrent state's read+write round trip (f32).
            b, h, hd, st = d["batch"], d["heads"], d["head_dim"], d["state"]
            dm = d.get("d_model", h * hd)
            return {"maps": b * d["seq"] * dm * by
                    + 2.0 * b * h * hd * st * 4.0,
                    "weights": float(d.get("weight_bytes", 0)),
                    "out": b * d["seq"] * dm * by}
        if k is LayerKind.WKV:
            # Coarse RWKV6 block: activations in/out plus the (h, hd,
            # hd) wkv state round trip (f32).
            b, h, hd = d["batch"], d["heads"], d["head_dim"]
            dm = d.get("d_model", h * hd)
            return {"maps": b * d["seq"] * dm * by
                    + 2.0 * b * h * hd * hd * 4.0,
                    "weights": float(d.get("weight_bytes", 0)),
                    "out": b * d["seq"] * dm * by}
        if k is LayerKind.ATTENTION:
            b, h, hd = d["batch"], d["heads"], d["head_dim"]
            kvh = d.get("kv_heads", h)
            q = b * h * d["seq_q"] * hd * by
            kv = 2 * b * kvh * d["seq_kv"] * hd * by
            return {"maps": q + kv, "weights": 0.0, "out": q}
        if k is LayerKind.EMBED:
            # maps: the int32 token ids; weights: the gathered rows (one
            # table row per token, not the whole table); out: the dense
            # activations the rest of the chain consumes.
            toks = d.get("tokens", d.get("numel", 0))
            dm = d.get("d_model", 1)
            return {"maps": toks * 4.0,
                    "weights": toks * dm * by,
                    "out": toks * dm * by}
        n = float(d.get("numel", 0))
        # Binary elementwise ops (GLU mul) stream both operands.
        reads = max(len(self.inputs), 1) if k is LayerKind.ELEMENTWISE else 1
        return {"maps": reads * n * by, "weights": 0.0, "out": n * by}

    def min_bytes(self) -> float:
        return sum(self.operand_bytes().values())

    def arithmetic_intensity(self) -> float:
        b = self.min_bytes()
        return self.flops() / b if b else float("inf")


def _conv_out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


def kernel_kind(node: "LayerNode") -> str:
    """The executor kernel a node lowers to — the kind key shared by
    trace records (``runtime/executor``), cost-model fits
    (``core/cost``), and tuned-cache signatures (``core/autotune``)."""
    if node.kind is LayerKind.CONV2D:
        return "conv2d"
    if node.kind is LayerKind.MATMUL:
        return "matmul"
    if node.kind is LayerKind.MOE:
        return "moe_dispatch"
    if node.kind is LayerKind.ATTENTION:
        if node.meta.get("cross"):
            return "cross_attention"
        return ("decode_attention" if node.meta.get("decode")
                else "flash_attention")
    if node.kind is LayerKind.POOL:
        return "avgpool" if node.meta.get("op") == "avg" else "maxpool"
    if node.kind is LayerKind.EMBED:
        return "embed"
    if node.kind is LayerKind.NORM:
        return "norm"
    return node.meta.get("op", node.kind.value)


def pool_out(size: int, window: int, stride: int, pad: int = 0) -> int:
    """Pooled output extent — one definition shared by the scheduler and
    the conv2d fused-pool path (same formula as _conv_out, named for the
    call sites that mean pooling)."""
    return (size + 2 * pad - window) // stride + 1


# --- graph --------------------------------------------------------------------
@dataclass
class ModelGraph:
    """Ordered layer graph.  The paper's doubly-linked list + labels."""

    name: str
    nodes: list[LayerNode] = field(default_factory=list)

    def add(self, node: LayerNode) -> LayerNode:
        if node.name in self._index():
            raise ValueError(f"duplicate layer name: {node.name}")
        self.nodes.append(node)
        return node

    def _index(self) -> dict[str, LayerNode]:
        return {n.name: n for n in self.nodes}

    def __iter__(self) -> Iterator[LayerNode]:
        return iter(self.nodes)

    def __len__(self) -> int:
        return len(self.nodes)

    def get(self, name: str) -> LayerNode:
        return self._index()[name]

    def _consumers(self) -> dict[str, list[str]]:
        """name -> names of nodes reading it via ``inputs`` (bypass_of
        reads are tracked separately by the passes that care)."""
        consumers: dict[str, list[str]] = {}
        for n in self.nodes:
            for inp in n.inputs:
                consumers.setdefault(inp, []).append(n.name)
        return consumers

    # --- paper step 2: dependency labelling -----------------------------------
    def mark_residuals(self) -> None:
        """Scan inter-layer relations and attach dependency labels.

        Any node consumed by a non-adjacent later node becomes a
        RESIDUAL_SOURCE; the consumer that lists it in ``bypass_of``
        becomes a RESIDUAL_SINK.  Nodes sharing an input are PARALLEL.
        """
        idx = self._index()
        consumers = self._consumers()
        order = {n.name: i for i, n in enumerate(self.nodes)}
        for n in self.nodes:
            if n.bypass_of is not None:
                n.dep = DepLabel.RESIDUAL_SINK
                src = idx.get(n.bypass_of)
                if src is not None and src.dep is DepLabel.SEQUENTIAL:
                    src.dep = DepLabel.RESIDUAL_SOURCE
        for src, cons in consumers.items():
            if len(cons) > 1:
                for c in cons:
                    node = idx[c]
                    if node.dep is DepLabel.SEQUENTIAL:
                        node.dep = DepLabel.PARALLEL
                if src in idx and idx[src].dep is DepLabel.SEQUENTIAL:
                    idx[src].dep = DepLabel.RESIDUAL_SOURCE
        # Sanity: a sink's source must precede it.
        for n in self.nodes:
            if n.bypass_of and n.bypass_of in order:
                if order[n.bypass_of] >= order[n.name]:
                    raise ValueError(
                        f"bypass source {n.bypass_of} does not precede {n.name}")

    def mark_pool_fusion(self) -> None:
        """Mark conv -> pool pairs fusable into the conv's epilogue.

        Fusable when the pool directly follows the conv, consumes only
        it, and the raw conv output has no other reader (no residual /
        parallel path off it) — then the pool can run on-chip before
        writeback and its HBM round trip vanishes.  Both max and avg
        pools fuse; the pool op rides along in the meta so the epilogue
        knows whether to take a running max or a window-sum/divide.
        This is a *graph* property; whether the fusion actually
        executes is the scheduler's call (it needs the zero-copy strip
        path), recorded in the conv's ``LayerSchedule.notes``.
        """
        consumers = self._consumers()
        bypass_sources = {n.bypass_of for n in self.nodes if n.bypass_of}
        for i, n in enumerate(self.nodes[:-1]):
            nxt = self.nodes[i + 1]
            if (n.kind is not LayerKind.CONV2D
                    or nxt.kind is not LayerKind.POOL
                    or nxt.meta.get("op", "max") not in ("max", "avg")
                    or "window" not in nxt.meta
                    or nxt.inputs != [n.name]
                    or n.name in bypass_sources
                    or consumers.get(n.name, []) != [nxt.name]):
                continue
            n.meta["fused_pool"] = {"window": nxt.meta["window"],
                                    "stride": nxt.meta["stride"],
                                    "pad": nxt.meta.get("pad", 0),
                                    "op": nxt.meta.get("op", "max")}
            nxt.meta["fused_into"] = n.name

    # --- aggregates ------------------------------------------------------------
    def total_flops(self) -> float:
        return sum(n.flops() for n in self.nodes)

    def total_min_bytes(self) -> float:
        return sum(n.min_bytes() for n in self.nodes)


# --- node constructors ----------------------------------------------------------
def matmul_node(name: str, M: int, K: int, N: int, *, dtype_bytes: int = 2,
                inputs: list[str] | None = None, bypass_of: str | None = None,
                fused_bias: bool = False, fused_activation: str | None = None,
                **meta) -> LayerNode:
    return LayerNode(
        name=name, kind=LayerKind.MATMUL,
        dims={"M": M, "K": K, "N": N}, dtype_bytes=dtype_bytes,
        inputs=inputs or [], bypass_of=bypass_of, fused_bias=fused_bias,
        fused_activation=fused_activation, meta=meta)


def attention_node(name: str, *, seq_q: int, seq_kv: int, heads: int,
                   kv_heads: int, head_dim: int, batch: int = 1,
                   causal: bool = True, dtype_bytes: int = 2,
                   inputs: list[str] | None = None, **meta) -> LayerNode:
    """Softmax-attention node; ``inputs`` is [q, k, v] producer names."""
    return LayerNode(
        name=name, kind=LayerKind.ATTENTION,
        dims={"seq_q": seq_q, "seq_kv": seq_kv, "heads": heads,
              "kv_heads": kv_heads, "head_dim": head_dim, "batch": batch,
              "causal": causal},
        dtype_bytes=dtype_bytes, inputs=inputs or [], meta=meta)


def decode_attention_node(name: str, *, cache_len: int, heads: int,
                          kv_heads: int, head_dim: int, slots: int,
                          k_cache: str, v_cache: str, dtype_bytes: int = 2,
                          window: int | None = None,
                          inputs: list[str] | None = None,
                          **meta) -> LayerNode:
    """Single-token decode attention against a persistent KV cache.

    ``inputs`` is [q, k_new, v_new] producer names (the per-token QKV
    projections); ``k_cache`` / ``v_cache`` name the *persistent*
    regions (core/regions.py) the op reads the history from and writes
    the new token's K/V into at the per-slot position — the position is
    a runtime operand carried by the executor's ``ProgramState``, never
    baked into the instruction stream.

    ``window`` marks sliding-window attention: the §5.1 region plan
    then sizes the cache at ``cache_len = min(max_len, window)`` rows
    per slot and eviction is the rolling overwrite at ``pos %
    cache_len`` — older rows are never attendable, so they never need
    to be resident."""
    win_meta = {"window": window} if window else {}
    return LayerNode(
        name=name, kind=LayerKind.ATTENTION,
        dims={"seq_q": 1, "seq_kv": cache_len, "heads": heads,
              "kv_heads": kv_heads, "head_dim": head_dim, "batch": slots,
              "causal": True},
        dtype_bytes=dtype_bytes, inputs=inputs or [],
        meta={"decode": True, "k_cache": k_cache, "v_cache": v_cache,
              **win_meta, **meta})


def cross_attention_node(name: str, *, seq_q: int, mem_len: int, heads: int,
                         kv_heads: int, head_dim: int, batch: int = 1,
                         k_mem: str, v_mem: str, dtype_bytes: int = 2,
                         decode: bool = False,
                         inputs: list[str] | None = None, **meta) -> LayerNode:
    """Cross-attention against *read-only* persistent encoder memory.

    ``inputs`` is just [q]; ``k_mem`` / ``v_mem`` name the persistent
    regions (core/regions.py state_specs) holding the encoder's K/V,
    written once at admission and only ever read afterwards — there is
    no per-token cache write and no ring, so the op is position-free.
    The decode variant reads the same regions at batch = slots."""
    return LayerNode(
        name=name, kind=LayerKind.ATTENTION,
        dims={"seq_q": seq_q, "seq_kv": mem_len, "heads": heads,
              "kv_heads": kv_heads, "head_dim": head_dim, "batch": batch,
              "causal": False},
        dtype_bytes=dtype_bytes, inputs=inputs or [],
        meta={"cross": True, "k_cache": k_mem, "v_cache": v_mem,
              **({"decode": True} if decode else {}), **meta})


def ssm_scan_node(name: str, *, seq: int, heads: int, head_dim: int,
                  state: int, d_model: int, batch: int = 1,
                  weight_bytes: float = 0.0, dtype_bytes: int = 2,
                  inputs: list[str] | None = None,
                  bypass_of: str | None = None, **meta) -> LayerNode:
    """Coarse Mamba2 block op: norm + in_proj + causal conv + selective
    scan + gated out_proj, residual add fused on the writeback.  ``meta``
    names the persistent recurrence regions (``ssm_state`` and
    ``conv_state``) and the stacked-parameter group path."""
    return LayerNode(
        name=name, kind=LayerKind.SSM_SCAN,
        dims={"seq": seq, "heads": heads, "head_dim": head_dim,
              "state": state, "d_model": d_model, "batch": batch,
              "weight_bytes": weight_bytes},
        dtype_bytes=dtype_bytes, inputs=inputs or [], bypass_of=bypass_of,
        meta=meta)


def wkv_node(name: str, *, seq: int, heads: int, head_dim: int,
             d_model: int, batch: int = 1, weight_bytes: float = 0.0,
             dtype_bytes: int = 2, inputs: list[str] | None = None,
             **meta) -> LayerNode:
    """Coarse RWKV6 block op: ln1 + time-mix (wkv recurrence) + ln2 +
    channel-mix, both residual adds internal.  ``meta`` names the
    persistent ``wkv_state`` / ``shift_t`` / ``shift_c`` regions and
    the stacked-parameter group path."""
    return LayerNode(
        name=name, kind=LayerKind.WKV,
        dims={"seq": seq, "heads": heads, "head_dim": head_dim,
              "d_model": d_model, "batch": batch,
              "weight_bytes": weight_bytes},
        dtype_bytes=dtype_bytes, inputs=inputs or [], meta=meta)


def moe_node(name: str, *, tokens: int, d_model: int, d_ff: int,
             experts: int, top_k: int, dtype_bytes: int = 2,
             inputs: list[str] | None = None, bypass_of: str | None = None,
             fused_activation: str | None = None, **meta) -> LayerNode:
    """Capacity-bucketed expert-MLP dispatch (paper §6 load balancing):
    route each token to its top-k experts, bucket per expert up to the
    capacity granule, run the expert FFN as grouped matmuls, and
    combine weighted by the router probabilities.  One op per MoE
    layer's MLP; the residual add fuses on the writeback."""
    return LayerNode(
        name=name, kind=LayerKind.MOE,
        dims={"M": tokens, "K": d_model, "N": d_ff,
              "experts": experts, "top_k": top_k},
        dtype_bytes=dtype_bytes, inputs=inputs or [], bypass_of=bypass_of,
        fused_activation=fused_activation, meta=meta)


def norm_node(name: str, numel: int, *, dtype_bytes: int = 2,
              inputs: list[str] | None = None, **meta) -> LayerNode:
    return LayerNode(name=name, kind=LayerKind.NORM,
                     dims={"numel": numel}, dtype_bytes=dtype_bytes,
                     inputs=inputs or [], meta=meta)


def embed_node(name: str, tokens: int, vocab: int, d_model: int, *,
               dtype_bytes: int = 2, **meta) -> LayerNode:
    """Token-embedding gather; reads the model input (int32 token ids)."""
    return LayerNode(name=name, kind=LayerKind.EMBED,
                     dims={"tokens": tokens, "vocab": vocab,
                           "d_model": d_model},
                     dtype_bytes=dtype_bytes, meta=meta)


def elementwise_node(name: str, op: str, numel: int, *,
                     dtype_bytes: int = 2,
                     inputs: list[str] | None = None, **meta) -> LayerNode:
    """Binary elementwise op (``op``: "mul" | "add") on two inputs —
    the GLU gating multiply is the LM lowering's only standalone one
    (residual adds fuse into the producing matmul's writeback)."""
    return LayerNode(name=name, kind=LayerKind.ELEMENTWISE,
                     dims={"numel": numel}, dtype_bytes=dtype_bytes,
                     inputs=inputs or [], meta={"op": op, **meta})


def conv_node(name: str, H: int, W: int, C_in: int, C_out: int, kh: int,
              kw: int, stride: int = 1, pad: int = 0, batch: int = 1, *,
              dtype_bytes: int = 2, inputs: list[str] | None = None,
              bypass_of: str | None = None, fused_bias: bool = True,
              fused_activation: str | None = "relu", **meta) -> LayerNode:
    return LayerNode(
        name=name, kind=LayerKind.CONV2D,
        dims={"H": H, "W": W, "C_in": C_in, "C_out": C_out, "kh": kh,
              "kw": kw, "stride": stride, "pad": pad, "batch": batch},
        dtype_bytes=dtype_bytes, inputs=inputs or [], bypass_of=bypass_of,
        fused_bias=fused_bias, fused_activation=fused_activation, meta=meta)
