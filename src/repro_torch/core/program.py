"""Executable Program — the instruction-stream analogue (paper §5.2).

``compile_model`` stops at a ``ModelSchedule``: per-layer decisions
(tiling, loop order, strip storage, fusion flags) with modeled cost.
The paper's compiler keeps going — it allocates memory regions from the
dependency labels and emits the instruction stream Snowflake executes.
This module is that last lowering step for us: a ``Program`` is an
ordered list of ``ProgramOp``s, each carrying

* the kernel id to dispatch (conv2d / matmul / maxpool / avgpool for
  the CNN families; embed / norm / flash_attention / mul for the LM
  families),
* the *resolved* schedule for that op — ``ConvTiling``, matmul block,
  or attention (block_q, block_kv) — so the kernels recompute nothing,
* the fusion epilogue (bias, activation, residual bypass, fused pool),
  exactly the paper's VMOV-on-writeback flags,
* input / output / bypass *memory-region* ids from the §5.1 region
  plan (core/regions.py).

``runtime/executor.py`` executes a Program against parameters; the
models compile once (cached) and run it, so every scheduler improvement
is automatically an execution improvement, never just a report.

Invariants (relied on by the executor, the tests and the docs):

* **Ops never re-derive tilings.**  Every schedule-shaped field on a
  ``ProgramOp`` (conv_tiling, block, strip_storage, dataflow, attention
  blocks) is resolved here, from the ``ModelSchedule``, at lowering
  time.  The executor passes them through verbatim; a kernel falling
  back to its own heuristics is a lowering bug, not a feature.
* **Region ids are allocator-owned.**  ``in_region`` / ``out_region``
  / ``bypass_region`` / ``k_region`` / ``v_region`` / ``in2_region``
  come exclusively from the §5.1 ``RegionPlan`` — and the persistent
  ``k_cache_region`` / ``v_cache_region`` ids from its persistent
  table; this module only maps producer/state names to the allocator's
  ids and never invents one.
* **``listing()`` is stable.**  For a fixed (graph, hw, batch) the
  listing is a deterministic function of the schedule — docs and CI
  reproduce it verbatim via ``examples/inspect_schedule.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

from .dataflow import Dataflow
from .ir import LayerKind, ModelGraph
from .regions import (PAGE_TABLE_REGION, PagedPlan, RegionPlan, StateCaps,
                      allocate_regions)
from .schedule import LayerSchedule, ModelSchedule
from .tiling import ConvTiling

__all__ = ["AttentionSpec", "ProgramOp", "Program", "ProgramPair",
           "lower_to_program"]


@dataclass(frozen=True)
class AttentionSpec:
    """Resolved geometry + schedule of one ``flash_attention`` op.

    Fields:

    * ``heads`` / ``kv_heads`` / ``head_dim`` — the projection layout;
      the executor reshapes the flat (B, S, heads*head_dim) q region
      (and the KV analogues) into per-head layout with these, so the
      kernel never consults the model config.
    * ``causal`` — decoder-LM causal masking (fixed at lowering).
    * ``window`` — causal sliding-window size, or None for full.  On a
      ``decode_attention`` op a window additionally means the §5.1 plan
      sized the persistent cache regions at ``min(max_len, window)``
      rows (rolling eviction-by-overwrite); the executor derives the
      ring extent from the region shape, so the field is the *record*
      of the decision, never re-derived.
    * ``rope_theta`` — rotary base; the executor applies RoPE to q/k
      before the kernel when set, 0.0 disables it (e.g. learned
      absolute positions).
    * ``block_q`` / ``block_kv`` — the compiler's T2 score-loop tiles
      (core/tiling.py::select_attention_blocks), pinned so the kernel
      wrapper re-derives nothing at run time.
    * ``page_size`` — rows per KV page when the §5.1 plan paged the
      persistent cache (``regions.paged_kv_specs``), else None.  On a
      paged decode op the kv block IS the page (``block_kv ==
      page_size``, pinned by the tiling chooser) and the history is
      gathered through the op's page-table region.
    """

    heads: int
    kv_heads: int
    head_dim: int
    causal: bool = True
    window: int | None = None
    rope_theta: float = 0.0
    block_q: int = 128
    block_kv: int = 128
    page_size: int | None = None


@dataclass(frozen=True)
class ProgramOp:
    index: int                       # position in the instruction stream
    name: str                        # source layer name
    # "conv2d" | "matmul" | "maxpool" | "avgpool"
    #   | "embed" | "norm" | "flash_attention" | "decode_attention" | "mul"
    kernel: str
    in_region: int
    out_region: int
    param_key: str | None = None     # params path ("layer_03", "blocks/wq:3")
    param_key_b: str | None = None   # secondary param (layernorm bias)
    bypass_region: int | None = None
    k_region: int | None = None      # attention: K producer's region
    v_region: int | None = None      # attention: V producer's region
    in2_region: int | None = None    # mul: second operand's region
    # Persistent KV-cache regions (§5.1 extension).  On a
    # flash_attention op they mean "also write the computed K/V into
    # the cache at the runtime slot" (the prefill side of the pair); on
    # a decode_attention op they are where the history is read from and
    # the new token's K/V written at the per-slot position.  The slot /
    # position itself is a runtime operand (executor ProgramState),
    # never baked into the stream.
    k_cache_region: int | None = None
    v_cache_region: int | None = None
    # Paged KV (§5.1 paged plan).  When the allocator paged the cache,
    # k_cache_region / v_cache_region point at the page *pools* and
    # page_table_region at the shared (slots, pages_per_slot) int32
    # table that maps logical cache rows to pool pages; k/v_scale
    # regions hold per-page dequant scales when the plan quantized the
    # pool to int8.  All four resolve by name through the plan's
    # persistent table, like the caches themselves.
    page_table_region: int | None = None
    k_scale_region: int | None = None
    v_scale_region: int | None = None
    # Generic named state (§5.1 generalisation).  Family ops whose
    # persistent state is not KV-shaped — ssm_scan (recurrent state +
    # conv taps), wkv (wkv matrix + token-shift rows) — carry the
    # resolved persistent region ids here, in the family's documented
    # order.  Resolved by *name* through the plan's persistent table,
    # exactly like the KV cache fields above; the executor scatters
    # updates in place at the runtime slot.
    state_regions: tuple = ()
    # Static per-op config for family kernels (sorted (key, value)
    # pairs, hashable).  moe_dispatch carries top_k / capacity_factor /
    # activation / gated here so the executor never consults the model
    # config; plain dense ops leave it empty.
    op_cfg: tuple = ()
    # geometry
    stride: int = 1
    pad: int = 0
    window: int = 0                  # standalone pool window
    # fusion epilogue (the paper's writeback VMOVs)
    fuse_bias: bool = False
    fuse_activation: str | None = None
    fuse_bypass: bool = False
    bypass_first: bool = True
    fuse_pool: tuple[int, int, int, str] | None = None  # (window,stride,pad,op)
    # resolved schedule
    strip_storage: str | None = None
    dataflow: Dataflow | None = None
    conv_tiling: ConvTiling | None = None
    block: tuple[int, int, int] | None = None
    attn: AttentionSpec | None = None               # flash_attention only
    # op-shape details
    norm_kind: str | None = None     # "rmsnorm" | "layernorm" | "nonparametric"
    flatten_input: bool = False      # CNN fc: (B,H,W,C) -> (B, H*W*C)
    transpose_w: bool = False        # tied lm_head: use embed table W^T
    # modeled cost, carried for the listing / benchmarks / trace records
    flops: float = 0.0
    traffic_bytes: float = 0.0
    exec_time_s: float = 0.0         # schedule's (possibly calibrated) price

    def trace(self) -> str:
        """One paper-style instruction-trace line."""
        io = f"r{self.in_region}->r{self.out_region}"
        if self.kernel in ("flash_attention", "decode_attention"):
            io = (f"r{self.in_region},r{self.k_region},r{self.v_region}"
                  f"->r{self.out_region}")
        elif self.kernel in ("mul", "add"):
            sym = "*" if self.kernel == "mul" else "+"
            io = (f"r{self.in_region}{sym}r{self.in2_region}"
                  f"->r{self.out_region}")
        if self.bypass_region is not None:
            io += f"+r{self.bypass_region}"
        sched = ""
        if self.kernel == "conv2d" and self.conv_tiling is not None:
            ct = self.conv_tiling
            order = self.dataflow.value if self.dataflow else "?"
            sched = (f"{order} strips={ct.n_map_tiles}x{ct.n_kernel_tiles} "
                     f"rows={ct.out_rows} kpt={ct.kernels_per_tile} "
                     f"{self.strip_storage or 'auto'}")
        elif self.kernel == "matmul" and self.block is not None:
            order = self.dataflow.value if self.dataflow else "?"
            sched = f"{order} block={'x'.join(map(str, self.block))}"
            if self.transpose_w:
                sched += " W^T"
        elif self.kernel in ("maxpool", "avgpool"):
            sched = f"win={self.window} stride={self.stride}"
        elif self.kernel == "flash_attention" and self.attn is not None:
            a = self.attn
            sched = (f"h={a.heads}/{a.kv_heads}x{a.head_dim} "
                     f"bq={a.block_q} bkv={a.block_kv}"
                     f"{' causal' if a.causal else ''}"
                     f"{f' win={a.window}' if a.window else ''}"
                     f"{' rope' if a.rope_theta else ''}")
            if self.k_cache_region is not None:
                sched += (f" cache>r{self.k_cache_region},"
                          f"r{self.v_cache_region}@slot")
                if self.page_table_region is not None:
                    sched += (f" pt=r{self.page_table_region}"
                              f" pg={self.attn.page_size}")
        elif self.kernel == "decode_attention" and self.attn is not None:
            a = self.attn
            sched = (f"h={a.heads}/{a.kv_heads}x{a.head_dim} "
                     f"bkv={a.block_kv}"
                     f"{f' win={a.window}' if a.window else ''}"
                     f"{' rope' if a.rope_theta else ''}"
                     f" cache=r{self.k_cache_region},"
                     f"r{self.v_cache_region}@pos")
            if self.page_table_region is not None:
                sched += f" pt=r{self.page_table_region} pg={a.page_size}"
                if self.k_scale_region is not None:
                    sched += " int8"
        elif self.kernel == "norm":
            sched = self.norm_kind or ""
        elif self.kernel == "moe_dispatch":
            cfg = dict(self.op_cfg)
            sched = (f"experts={cfg.get('experts', '?')} "
                     f"top{cfg.get('top_k', '?')} "
                     f"cap={cfg.get('capacity_factor', '?')}")
        elif self.kernel in ("ssm_scan", "wkv"):
            sched = ("state=" + ",".join(f"r{r}" for r in self.state_regions)
                     + "@slot") if self.state_regions else ""
        elif self.kernel == "cross_attention" and self.attn is not None:
            a = self.attn
            sched = (f"h={a.heads}/{a.kv_heads}x{a.head_dim} "
                     f"mem=r{self.k_cache_region},"
                     f"r{self.v_cache_region}@slot")
        epi = "".join(
            [" +bias" if self.fuse_bias else "",
             f" +{self.fuse_activation}" if self.fuse_activation else "",
             " +bypass" if self.fuse_bypass else "",
             (f" +{'avg' if self.fuse_pool[3] == 'avg' else ''}pool"
              f"{self.fuse_pool[0]}s{self.fuse_pool[1]}"
              if self.fuse_pool else "")])
        return (f"%{self.index:02d} {self.kernel:8s} {self.name:14s} "
                f"{io:10s} {sched}{epi}")


@dataclass(frozen=True)
class Program:
    name: str
    hw_name: str
    ops: tuple[ProgramOp, ...]
    plan: RegionPlan

    @property
    def input_region(self) -> int:
        return self.plan.input_region

    @property
    def output_region(self) -> int:
        return self.plan.output_region

    @property
    def total_flops(self) -> float:
        return sum(op.flops for op in self.ops)

    @property
    def total_traffic_bytes(self) -> float:
        return sum(op.traffic_bytes for op in self.ops)

    def op(self, name: str) -> ProgramOp:
        for o in self.ops:
            if o.name == name:
                return o
        raise KeyError(name)

    def listing(self) -> str:
        plan = self.plan
        persist = ""
        if plan.n_persistent:
            persist = (f"+{plan.n_persistent} persistent "
                       f"({plan.persistent_bytes / 1e6:.2f} MB KV) ")
        head = (f"program {self.name} on {self.hw_name}: {len(self.ops)} ops, "
                f"{plan.n_pingpong}+{plan.n_pinned} regions "
                f"({plan.total_bytes / 1e6:.2f} MB) {persist}".rstrip() + ", "
                f"{self.total_flops / 1e9:.2f} GFLOP, "
                f"{self.total_traffic_bytes / 1e6:.1f} MB moved")
        return "\n".join([head] + [op.trace() for op in self.ops])


@dataclass(frozen=True)
class ProgramPair:
    """A prefill Program and a decode Program sharing one persistent
    region table (§5.1 extension) — the compiled form of stateful LM
    serving.  The prefill Program runs the full causal forward *and*
    writes each block's K/V into the persistent cache regions at an
    admitted slot; the decode Program advances every live slot by one
    token through ``decode_attention`` ops reading/writing the same
    regions.  Both plans embed identical persistent ids
    (``regions.extend_with_persistent`` with a shared base), so one
    runtime ``ProgramState`` serves both instruction streams.

    ``slots`` / ``max_len`` record the serving geometry the pair was
    compiled for.  The persistent-region shapes alone cannot recover
    ``max_len`` once a sliding window collapses the row count to
    ``min(max_len, attn_window)``, yet the prefill stream is still
    pinned to (1, max_len) token batches — so the engine validates a
    caller-supplied pair against these fields, not just the shapes.

    ``paged`` records the §5.1 paged-plan decision
    (``regions.PagedPlan``) when the persistent cache is a page pool +
    page table instead of contiguous (slots, cache_len) rows; None
    means contiguous.  The executor's host-side page allocator and the
    engine's COW admission both read their geometry from it."""

    prefill: Program
    decode: Program
    slots: int | None = None
    max_len: int | None = None
    paged: PagedPlan | None = None
    # Per-family state capabilities (regions.StateCaps) minted by the
    # family's ``state_specs`` hook alongside the specs themselves.
    # None means the pair predates the hook (treated as dense-KV: all
    # capabilities on) — the engine's paged/COW/chunk/speculation gates
    # consult this instead of assuming every family is KV-shaped.
    caps: StateCaps | None = None

    @property
    def page_table_region(self) -> int | None:
        """Region id of the shared page table, None when contiguous."""
        if self.paged is None:
            return None
        return self.decode.plan.persistent[PAGE_TABLE_REGION]

    @property
    def chunk_blocker(self) -> str | None:
        """Why this pair cannot serve *chunked* prefill (None = it
        can).  int8 paged pools quantize whole pages — the page scale
        is a function of every row in the page — while a chunk boundary
        inside a page writes rows under the scale of the rows seen so
        far, silently re-basing the ones a later chunk adds.  The
        engine checks this at construction, not mid-serve."""
        if self.paged is not None and self.paged.quantized:
            return ("int8 paged KV: page scales are whole-page "
                    "decisions, chunk writes are row-granular")
        if self.caps is not None and not self.caps.chunkable:
            return ("family state is not chunkable: recurrent state "
                    "after a chunk depends on every row before it, so "
                    "a chunk boundary cannot be resumed from the "
                    "persistent regions alone")
        return None

    @property
    def persistent(self) -> dict:
        return self.decode.plan.persistent

    @property
    def persistent_bytes(self) -> int:
        return self.decode.plan.persistent_bytes

    def listing(self) -> str:
        return (f"program pair {self.decode.name.removesuffix('.decode')}: "
                f"prefill {len(self.prefill.ops)} ops + decode "
                f"{len(self.decode.ops)} ops, "
                f"{len(self.persistent)} persistent KV regions "
                f"({self.persistent_bytes / 1e6:.2f} MB)\n"
                + self.prefill.listing() + "\n" + self.decode.listing())


def _pool_kernel(node) -> str:
    return "avgpool" if node.meta.get("op") == "avg" else "maxpool"


def _norm_pool(fp: dict) -> tuple[int, int, int, str]:
    return (fp["window"], fp["stride"], fp.get("pad", 0), fp.get("op", "max"))


def lower_to_program(graph: ModelGraph, schedule: ModelSchedule,
                     plan: RegionPlan | None = None) -> Program:
    """Lower a scheduled graph to the executable instruction stream.

    The schedule is the single source of truth: a pool is emitted as a
    standalone op exactly when the scheduler did *not* fuse it into its
    producer (``fused_pool`` in the conv's notes requires the zero-copy
    strip path), and every conv/matmul op carries the schedule's exact
    tiling, loop order and epilogue flags.
    """
    if plan is None:
        plan = allocate_regions(graph, schedule)
    nodes = list(graph)
    prev: str | None = None
    ops: list[ProgramOp] = []
    for node in nodes:
        ls: LayerSchedule = schedule.layer(node.name)
        src_name = node.inputs[0] if node.inputs else prev
        in_region = (plan.out_region[src_name] if src_name is not None
                     else plan.input_region)
        out_region = plan.out_region[node.name]
        prev = node.name
        fused_into = node.meta.get("fused_into")
        if fused_into is not None and "fused_into" in ls.notes:
            continue                      # runs inside its producer's epilogue
        common = dict(
            index=len(ops), name=node.name, in_region=in_region,
            out_region=out_region, param_key=node.meta.get("param"),
            flops=ls.flops, traffic_bytes=ls.traffic_bytes,
            exec_time_s=ls.exec_time_s)
        if node.kind is LayerKind.CONV2D:
            d = node.dims
            fp = ls.notes.get("fused_pool")
            ops.append(ProgramOp(
                kernel="conv2d", stride=d["stride"], pad=d["pad"],
                fuse_bias=ls.fuse_bias, fuse_activation=ls.fuse_activation,
                fuse_bypass=ls.fuse_bypass,
                bypass_region=(plan.out_region[node.bypass_of]
                               if node.bypass_of else None),
                bypass_first=node.meta.get("bypass_first", True),
                fuse_pool=_norm_pool(fp) if fp else None,
                strip_storage=ls.notes.get("strip_storage"),
                dataflow=ls.dataflow, conv_tiling=ls.conv_tiling,
                **common))
        elif node.kind is LayerKind.MATMUL:
            ops.append(ProgramOp(
                kernel="matmul", fuse_bias=ls.fuse_bias,
                fuse_activation=ls.fuse_activation,
                fuse_bypass=ls.fuse_bypass,
                bypass_region=(plan.out_region[node.bypass_of]
                               if node.bypass_of else None),
                flatten_input=node.meta.get("flatten_input", False),
                transpose_w=node.meta.get("transpose_w", False),
                dataflow=ls.dataflow, block=ls.block, **common))
        elif node.kind is LayerKind.POOL:
            m = node.meta
            ops.append(ProgramOp(
                kernel=_pool_kernel(node), window=m.get("window", 1),
                stride=m.get("stride", 1), pad=m.get("pad", 0), **common))
        elif node.kind is LayerKind.EMBED:
            # param_key_b names a learned absolute position table the
            # executor adds after the gather (prefill: rows [0, T);
            # decode: the per-slot position row).
            ops.append(ProgramOp(
                kernel="embed", param_key_b=node.meta.get("param_b"),
                **common))
        elif node.kind is LayerKind.NORM:
            ops.append(ProgramOp(
                kernel="norm", norm_kind=node.meta.get("norm", "rmsnorm"),
                param_key_b=node.meta.get("param_b"), **common))
        elif node.kind is LayerKind.ATTENTION and node.meta.get("cross"):
            # Cross-attention reads per-slot *read-only* encoder memory
            # from persistent regions — there is no K/V producer in the
            # transient graph and nothing is ever written back, so the
            # op takes [q] alone and resolves both memory regions by
            # name through the persistent table.
            d = node.dims
            ops.append(ProgramOp(
                kernel="cross_attention",
                k_cache_region=plan.persistent[node.meta["k_cache"]],
                v_cache_region=plan.persistent[node.meta["v_cache"]],
                attn=AttentionSpec(
                    heads=d["heads"], kv_heads=d["kv_heads"],
                    head_dim=d["head_dim"], causal=False,
                    rope_theta=node.meta.get("rope_theta", 0.0),
                    block_q=ls.notes.get("block_q", 128),
                    block_kv=ls.notes.get("block_kv", 128)),
                **common))
        elif node.kind is LayerKind.ATTENTION:
            d = node.dims
            # Persistent cache regions resolve by *name* through the
            # plan's allocator-owned persistent table (shared across a
            # prefill/decode pair).
            k_cache = v_cache = None
            page_table = k_scale = v_scale = None
            if node.meta.get("k_cache") is not None:
                k_cache = plan.persistent[node.meta["k_cache"]]
                v_cache = plan.persistent[node.meta["v_cache"]]
                # Paged plan: the cache names resolve to page pools and
                # the op additionally carries the shared table (and the
                # per-page scale regions when the pool is int8).
                if node.meta.get("page_table") is not None:
                    page_table = plan.persistent[node.meta["page_table"]]
                    if node.meta.get("k_scale") is not None:
                        k_scale = plan.persistent[node.meta["k_scale"]]
                        v_scale = plan.persistent[node.meta["v_scale"]]
            ops.append(ProgramOp(
                kernel=("decode_attention" if node.meta.get("decode")
                        else "flash_attention"),
                k_region=plan.out_region[node.inputs[1]],
                v_region=plan.out_region[node.inputs[2]],
                k_cache_region=k_cache, v_cache_region=v_cache,
                page_table_region=page_table,
                k_scale_region=k_scale, v_scale_region=v_scale,
                attn=AttentionSpec(
                    heads=d["heads"], kv_heads=d["kv_heads"],
                    head_dim=d["head_dim"],
                    causal=ls.notes.get("causal", True),
                    window=ls.notes.get("window"),
                    rope_theta=node.meta.get("rope_theta", 0.0),
                    block_q=ls.notes.get("block_q", 128),
                    block_kv=ls.notes.get("block_kv", 128),
                    page_size=ls.notes.get("page_size")),
                **common))
        elif node.kind is LayerKind.MOE:
            # Capacity-bucketed expert dispatch (§6 load balancing):
            # one op covers route → bucket → per-expert matmuls →
            # un-permute.  The static routing config rides op_cfg so
            # the executor never consults the model config.
            d = node.dims
            ops.append(ProgramOp(
                kernel="moe_dispatch",
                fuse_bypass=ls.fuse_bypass,
                bypass_region=(plan.out_region[node.bypass_of]
                               if node.bypass_of else None),
                op_cfg=tuple(sorted({
                    "experts": d["experts"], "top_k": d["top_k"],
                    "capacity_factor": node.meta.get(
                        "capacity_factor", 1.25),
                    "activation": node.meta.get("activation", "silu"),
                    "gated": node.meta.get("gated", True),
                }.items())),
                **common))
        elif node.kind in (LayerKind.SSM_SCAN, LayerKind.WKV):
            # Coarse recurrent block op: the whole mixing block runs as
            # one kernel against generic named state (SSM recurrent +
            # conv taps, or wkv matrix + token-shift rows), scattered
            # in place at the runtime slot.  State region ids resolve
            # by name, in the family's documented order.
            ops.append(ProgramOp(
                kernel=("ssm_scan" if node.kind is LayerKind.SSM_SCAN
                        else "wkv"),
                state_regions=tuple(plan.persistent[s]
                                    for s in node.meta.get("states", ())),
                fuse_bypass=ls.fuse_bypass,
                bypass_region=(plan.out_region[node.bypass_of]
                               if node.bypass_of else None),
                op_cfg=tuple(sorted(node.meta.get("op_cfg", {}).items())),
                **common))
        elif (node.kind is LayerKind.ELEMENTWISE
              and node.meta.get("op") in ("mul", "add")):
            ops.append(ProgramOp(
                kernel=node.meta["op"],
                in2_region=plan.out_region[node.inputs[1]], **common))
        else:
            raise NotImplementedError(
                f"no program lowering for {node.kind} ({node.name}); "
                f"Program covers the CNN layer kinds, the dense-LM op "
                f"vocabulary (embed/norm/flash_attention/matmul/mul) "
                f"and the family ops (moe_dispatch/ssm_scan/wkv/"
                f"cross_attention)")
    return Program(name=graph.name, hw_name=schedule.hw_name,
                   ops=tuple(ops), plan=plan)
