"""Memory-region allocation (paper §5.1 step 5 / §5.3).

The paper's compiler turns the dependency labels into a *region plan*
for main memory: a sequential chain ping-pongs between two activation
regions (the consumer reads one while the producer writes the other),
and every residual/parallel source holds a dedicated pinned region
until its last consumer retires it.  The instruction stream then reads
and writes region ids, never raw addresses.

This module is that allocator for a ``ModelGraph`` + ``ModelSchedule``
pair: it walks the executed op order (a pool fused into its producer
conv is one op), decides ping-pong vs pinned per output from the
consumer distances, reuses pinned regions after their last read, and
sizes every region at the largest output it ever holds.  The resulting
``RegionPlan`` is embedded in the executable ``Program``
(core/program.py) and drives the executor's region file.

Beyond the paper's transient activation regions, the allocator also
owns **persistent** regions: state that outlives a single Program run
(the serving KV cache — one (slots, cache_len, kv_heads, head_dim)
region per transformer block and cache side).  A persistent region is
never assigned to an op output, never retired and never reused; its id
is shared by every Program compiled against the same persistent table
(the prefill/decode pair), so the runtime's ``ProgramState`` buffers
are addressed identically by both.  The sizing rule is the paper's
"region sized at the largest output it holds" applied to state: a
sliding-window attention config can never attend past its window, so
its cache_len is ``min(max_len, attn_window)`` (the caller's
``PersistentSpec`` shape) and eviction is the runtime's rolling
overwrite at ``pos % cache_len`` — a region-plan decision, not a
runtime one.

Invariants:

* **Region ids are allocator-owned.**  This module is the only place
  a region id is ever minted — transient ids by ``allocate_regions``,
  persistent ids by ``extend_with_persistent`` — the Program lowering
  maps producer/state names to these ids and the executor keys its
  region file by them.  No other module may invent, renumber or alias
  a region.
* The allocator is label-agnostic at assignment time: pinning follows
  *consumer distances* in the executed op order, so any graph shape —
  ResNet shortcuts, the transformer residual stream, QKV fan-outs —
  is handled by the same rule (read past the next op => pinned until
  one step after the last read, then the region is reused).
* Pinned-region reuse keeps the footprint depth-independent for
  repeated structures: a dense transformer needs 2 ping-pong + 4
  pinned regions regardless of layer count.  Persistent regions are
  exempt: state cannot be reused across layers, so the KV table grows
  with depth by design.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

from .ir import ModelGraph

__all__ = ["Region", "RegionPlan", "PersistentSpec", "PagedPlan",
           "StateCaps", "allocate_regions", "extend_with_persistent",
           "paged_kv_specs", "pages_for_len", "register_state_family",
           "state_specs", "PAGE_TABLE_REGION"]

N_PINGPONG = 2          # the paper's sequential double-buffer pair

# Element sizes of the dtype names persistent specs carry (the reference
# asks jnp.dtype for these; a table keeps this module framework-free).
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int32": 4,
               "int8": 1, "float8_e4m3fn": 1, "float8": 1}


@dataclass(frozen=True)
class Region:
    rid: int
    kind: str            # "pingpong" | "pinned" | "persistent"
    size_bytes: int      # largest output this region ever holds
    # Persistent regions only: allocation identity the runtime builds
    # its state buffers from.  Transient regions leave these None.
    name: str | None = None
    shape: tuple | None = None
    dtype: str | None = None     # numpy dtype name ("float32", "bfloat16")


@dataclass(frozen=True)
class PersistentSpec:
    """One named persistent buffer to reserve.

    Historically always a KV table; a spec is now *generic named
    state*: an SSM recurrence ``(slots, heads, dn, dh)``, an rwkv
    wkv/shift pair, a hybrid's conv tail, or read-only encoder memory
    for cross-attention.  ``read_only`` marks state the decode stream
    only ever reads (encoder memory written once at admission); the
    executor never scatters into such a region and tests pin that.
    """

    name: str
    shape: tuple
    dtype: str                   # numpy dtype name
    size_bytes: int
    read_only: bool = False


@dataclass(frozen=True)
class RegionPlan:
    regions: tuple[Region, ...]          # transient regions: rid == index
    out_region: dict                     # layer name -> rid of its output
    input_region: int                    # rid the model input arrives in
    output_region: int                   # rid holding the final output
    # name -> rid of every persistent region (allocator-owned ids minted
    # by extend_with_persistent; shared across a Program pair).
    persistent: dict = field(default_factory=dict)

    @property
    def n_pingpong(self) -> int:
        return sum(1 for r in self.regions if r.kind == "pingpong")

    @property
    def n_pinned(self) -> int:
        return sum(1 for r in self.regions if r.kind == "pinned")

    @property
    def n_persistent(self) -> int:
        return sum(1 for r in self.regions if r.kind == "persistent")

    @property
    def total_bytes(self) -> int:
        """Activation footprint the plan reserves (sum of region sizes —
        the paper allocates the regions once, up front)."""
        return sum(r.size_bytes for r in self.regions
                   if r.kind != "persistent")

    @property
    def persistent_bytes(self) -> int:
        return sum(r.size_bytes for r in self.regions
                   if r.kind == "persistent")

    def region(self, rid: int) -> Region:
        # Transient rids index the tuple directly; persistent rids may
        # sit past a shared base (pair-aligned), so fall back to search.
        if rid < len(self.regions) and self.regions[rid].rid == rid:
            return self.regions[rid]
        for r in self.regions:
            if r.rid == rid:
                return r
        raise KeyError(rid)

    def persistent_regions(self) -> tuple:
        return tuple(r for r in self.regions if r.kind == "persistent")


def _fused_into(node, schedule) -> str | None:
    """Producer this pool runs inside of, under the given schedule (the
    schedule decides — materialized strips do not fuse), falling back to
    the graph annotation when no schedule is supplied."""
    src = node.meta.get("fused_into")
    if src is None:
        return None
    if schedule is None:
        return src
    try:
        return src if "fused_pool" in schedule.layer(src).notes else None
    except KeyError:
        return None


def allocate_regions(graph: ModelGraph, schedule=None) -> RegionPlan:
    """Turn dependency labels into the §5.1 region plan.

    Outputs consumed only by the next executed op alternate between the
    two ping-pong regions; an output read later than that (residual
    source, parallel-path input) is pinned to its own region until its
    last consumer executes, after which the region is reused.
    """
    nodes = list(graph)
    # --- executed-op order: a fused pool collapses into its conv ------------
    step_of: dict[str, int] = {}         # node name -> executed step
    out_bytes: dict[int, float] = {}     # step -> bytes its output occupies
    steps: list = []                     # step -> producing node
    for node in nodes:
        src = _fused_into(node, schedule)
        if src is not None and src in step_of:
            s = step_of[src]
            step_of[node.name] = s       # pool output lives in conv's region
            out_bytes[s] = node.operand_bytes()["out"]   # pooled, smaller
            continue
        s = len(steps)
        steps.append(node)
        step_of[node.name] = s
        out_bytes[s] = node.operand_bytes()["out"]

    # --- consumer steps per producing step ----------------------------------
    consumers: dict[int, list[int]] = {s: [] for s in range(len(steps))}
    input_consumers: list[int] = []      # steps reading the model input
    prev: str | None = None
    for node in nodes:
        s = step_of[node.name]
        reads = list(node.inputs)
        if node.bypass_of:
            reads.append(node.bypass_of)
        if not node.inputs and prev is not None:
            reads.append(prev)           # implicit sequential input
        for r in reads:
            ps = step_of.get(r)
            if ps is not None and ps != s:
                consumers[ps].append(s)
            elif ps is None:
                input_consumers.append(s)
        if not reads:
            input_consumers.append(s)
        prev = node.name
    for s in consumers:
        consumers[s] = sorted(set(consumers[s]))

    # --- assignment ----------------------------------------------------------
    input_bytes = steps[0].operand_bytes().get("maps", 0.0) if steps else 0.0
    sizes: dict[int, float] = {0: input_bytes, 1: 0.0}
    kinds: dict[int, str] = {0: "pingpong", 1: "pingpong"}
    out_region: dict[str, int] = {}
    input_region = 0
    free_pinned: list[int] = []
    retire_at: dict[int, list[int]] = {}   # step -> pinned rids freed after it

    if input_consumers and max(input_consumers) > 0:
        # The raw input outlives step 0's write slot: pin it.  (No paper
        # CNN does this — the graphs branch on layer outputs only — but
        # the allocator must not silently corrupt such a graph.)
        input_region = 2
        kinds[input_region] = "pinned"
        sizes[input_region] = sizes.pop(0)
        sizes[0] = 0.0

    def assign(step: int, rid: int) -> None:
        sizes[rid] = max(sizes.get(rid, 0.0), out_bytes[step])

    for s, node in enumerate(steps):
        for rid in retire_at.pop(s, []):
            free_pinned.append(rid)
        cons = consumers[s]
        pinned = bool(cons) and max(cons) > s + 1
        if pinned:
            if free_pinned:
                rid = min(free_pinned)
                free_pinned.remove(rid)
            else:
                rid = len(sizes)
                kinds[rid] = "pinned"
            # Free one step AFTER the last consumer: the consuming op is
            # still streaming this region while it writes its own output,
            # so the region cannot double as that output.
            retire_at.setdefault(max(cons) + 1, []).append(rid)
        else:
            # Strict alternation: the input occupies ping-pong 0, step s
            # writes ping-pong (s+1) % 2.  Anything still needed past the
            # next step is pinned above, so the overwritten slot is dead.
            rid = (s + 1) % N_PINGPONG
        assign(s, rid)
        out_region[node.name] = rid

    # Alias fused pools (and any other collapsed nodes) to their step's rid.
    for name, s in step_of.items():
        if name not in out_region:
            out_region[name] = out_region[steps[s].name]

    regions = tuple(Region(rid, kinds[rid], int(sizes.get(rid, 0.0)))
                    for rid in range(len(sizes)))
    final = out_region[steps[-1].name] if steps else input_region
    return RegionPlan(regions=regions, out_region=out_region,
                      input_region=input_region, output_region=final)


def extend_with_persistent(plan: RegionPlan, specs: tuple,
                           base_rid: int | None = None) -> RegionPlan:
    """Reserve persistent regions on top of a transient plan.

    Persistent ids start at ``base_rid`` (default: one past the
    transient regions) so a *pair* of Programs can share one persistent
    table: compile both transient plans first, pass the same
    ``base_rid = max(len(p.regions) for p in plans)`` and the same
    ``specs`` to each, and the minted ids coincide — the runtime's
    state buffers are then addressed identically by both instruction
    streams.  Persistent regions never appear in ``out_region`` and are
    never reused or retired by the transient allocator.
    """
    base = len(plan.regions) if base_rid is None else base_rid
    if base < len(plan.regions):
        raise ValueError(
            f"persistent base rid {base} collides with "
            f"{len(plan.regions)} transient regions")
    persistent = dict(plan.persistent)
    extra = []
    for i, spec in enumerate(specs):
        if spec.name in persistent:
            raise ValueError(f"duplicate persistent region {spec.name!r}")
        rid = base + i
        persistent[spec.name] = rid
        extra.append(Region(rid, "persistent", int(spec.size_bytes),
                            name=spec.name, shape=tuple(spec.shape),
                            dtype=spec.dtype))
    return replace(plan, regions=plan.regions + tuple(extra),
                   persistent=persistent)


# --- paged KV plan (§5.1 third scheme: ping-pong, rolling-ring, paged) -------------
PAGE_TABLE_REGION = "page_table"     # the pair's one per-slot page-table region


@dataclass(frozen=True)
class PagedPlan:
    """The §5.1 allocator's paged-KV decision record.

    Instead of one contiguous (slots, cache_len) row table per block
    and side, the plan reserves a **fixed-size page pool** — ``n_pages``
    pages of ``page_size`` rows each, shared by every slot — plus one
    per-slot **page table** (slots, pages_per_slot) int32 mapping each
    slot's virtual row range onto pool pages.  Page ids are *slot
    agnostic*: two slots whose tables name the same page share its rows
    (copy-on-write prefix sharing), and a short sequence holds only the
    pages it has touched — admission stops reserving worst-case rows.

    Page 0 is the **null page**: never handed out by the runtime
    allocator, it is the write target for masked rows (dead slots, the
    shared span of a prefill) so scatters stay dense and branch-free.

    ``kv_dtype`` is the pool element type — "int8" stores quantized
    pages with one float32 scale per page and side (dequantized in the
    gather), any float dtype stores rows verbatim.  The virtual extent
    rule is ``ring_kv_len(pos, cache_len)`` with ``cache_len =
    pages_per_slot * page_size`` — the same shared rule as the rolling
    ring, applied through the table."""

    page_size: int
    n_pages: int                     # pool pages per block+side (incl. null)
    pages_per_slot: int
    kv_dtype: str = "float32"

    @property
    def cache_len(self) -> int:
        return self.pages_per_slot * self.page_size

    @property
    def quantized(self) -> bool:
        return self.kv_dtype == "int8"


def paged_kv_specs(*, n_layers: int, kv_heads: int, head_dim: int,
                   slots: int, max_len: int, page_size: int,
                   n_pages: int | None = None,
                   kv_dtype: str = "float32"
                   ) -> tuple[tuple[PersistentSpec, ...], PagedPlan]:
    """Mint the paged persistent table: per block+side a page pool
    ``l{i}.k_pages`` / ``l{i}.v_pages`` of (n_pages, page_size,
    kv_heads, head_dim) — int8 pools additionally carry per-page scale
    vectors ``l{i}.k_scale`` / ``l{i}.v_scale`` (n_pages,) float32 —
    plus the single shared ``page_table`` region (slots,
    pages_per_slot) int32.

    ``n_pages`` defaults to worst case (every slot fully resident plus
    the null page); a caller fixing an HBM budget passes fewer pages
    and the runtime allocator admits only what fits — the
    serve-more-sequences-per-byte knob."""
    if max_len % page_size:
        raise ValueError(
            f"paged KV needs max_len ({max_len}) divisible by "
            f"page_size ({page_size}) so prefill rows tile into pages")
    pages_per_slot = max_len // page_size
    if n_pages is None:
        # +1 null page, and never below the floor (one full slot + a
        # spare COW/fork page) even for a single-slot pool.
        n_pages = max(1 + slots * pages_per_slot, 2 + pages_per_slot)
    if n_pages < 2 + pages_per_slot:
        raise ValueError(
            f"page pool of {n_pages} cannot hold even one full slot "
            f"({pages_per_slot} pages) plus the null page")
    pool_shape = (n_pages, page_size, kv_heads, head_dim)
    by = DTYPE_BYTES[kv_dtype]
    pool_bytes = math.prod(pool_shape) * by
    specs: list[PersistentSpec] = []
    for i in range(n_layers):
        specs.append(PersistentSpec(f"l{i}.k_pages", pool_shape,
                                    "int8" if kv_dtype == "int8" else kv_dtype,
                                    pool_bytes))
        specs.append(PersistentSpec(f"l{i}.v_pages", pool_shape,
                                    "int8" if kv_dtype == "int8" else kv_dtype,
                                    pool_bytes))
        if kv_dtype == "int8":
            specs.append(PersistentSpec(f"l{i}.k_scale", (n_pages,),
                                        "float32", n_pages * 4))
            specs.append(PersistentSpec(f"l{i}.v_scale", (n_pages,),
                                        "float32", n_pages * 4))
    specs.append(PersistentSpec(PAGE_TABLE_REGION, (slots, pages_per_slot),
                                "int32", slots * pages_per_slot * 4))
    plan = PagedPlan(page_size=page_size, n_pages=n_pages,
                     pages_per_slot=pages_per_slot, kv_dtype=kv_dtype)
    return tuple(specs), plan


def pages_for_len(length: int, page_size: int) -> int:
    """Pages a sequence of ``length`` rows occupies (host-side rule the
    runtime page allocator and the admission path share)."""
    return max(0, math.ceil(length / page_size))


# --- generic named state: the per-family state_specs hook ----------------------
@dataclass(frozen=True)
class StateCaps:
    """What the serving engine may do with a family's persistent state.

    The engine's paged/COW, windowed, chunked-prefill and speculative-
    decode gates consult these instead of assuming KV shape:

    * ``paged``       — state is row-addressable KV, so the §5.1 paged
                        plan (page pools + page table, COW prefix
                        sharing) applies.
    * ``windowed``    — a sliding ``attn_window`` maps onto ring
                        eviction at ``pos % cache_len``.
    * ``chunkable``   — prefill may be split into row chunks; true only
                        when mid-prefill state is a pure row table (a
                        half-written recurrence is not resumable by the
                        chunk runner).
    * ``speculatable``— rejected draft tokens can be rolled back by
                        truncating ``lengths`` (KV rows are simply
                        overwritten; a mutated recurrence cannot be
                        un-stepped).
    """

    paged: bool = False
    windowed: bool = False
    chunkable: bool = False
    speculatable: bool = False


# family name -> fn(cfg, slots, max_len) -> (tuple[PersistentSpec], StateCaps)
_STATE_FAMILIES: dict = {}


def register_state_family(family: str, fn) -> None:
    """Register a family's persistent-state minting hook.

    Model modules call this at import time (``models/registry.py``
    imports them all), keeping the allocator the only place region ids
    are minted while the *shapes* stay family-owned.
    """
    _STATE_FAMILIES[family] = fn


def state_specs(cfg, slots: int, max_len: int
                ) -> tuple[tuple[PersistentSpec, ...], StateCaps]:
    """Mint the persistent-state specs + capabilities for one config.

    Every spec's leading axis is ``slots`` — the one engine-visible
    invariant; everything after that is family business (KV rows, SSM
    heads, wkv matrices, encoder memory...).  Raises
    ``NotImplementedError`` naming the family when no hook is
    registered, which the serving engine surfaces as its fallback
    reason.
    """
    fn = _STATE_FAMILIES.get(cfg.family)
    if fn is None:
        raise NotImplementedError(
            f"{cfg.name} is blocked by: family {cfg.family!r} has no "
            f"registered state_specs hook — it still runs the scan "
            f"forward")
    specs, caps = fn(cfg, slots, max_len)
    for s in specs:
        if not s.shape or s.shape[0] != slots:
            raise ValueError(
                f"state spec {s.name!r} leading axis {s.shape[:1]} != "
                f"slots ({slots}); per-slot addressing requires axis 0 "
                f"to be the slot axis")
    return tuple(specs), caps
