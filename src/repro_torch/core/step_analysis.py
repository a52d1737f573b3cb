"""Step analyzer: FLOPs, HBM bytes, collective link bytes and memory per
rank of one eager call (counterpart of ``repro/core/hlo_analysis.py``).

The reference compiles a step with XLA and parses the optimized HLO
text: dots and convolutions give FLOPs, top-level ops HBM bytes (fusion
internals are VMEM), collectives their link bytes, and ``while`` trip
counts multiply each scan body.  torch has no HLO.  ``analyze_step``
runs the step once, eagerly, on the rank's process group (usually a
fake one of 256 / 512 ranks over fake tensors: ``launch/dryrun.py``),
and counts what the call dispatches:

* **FLOPs** from ``torch.utils.flop_counter.FlopCounterMode`` (matrix
  products, convolutions, attention);
* **HBM bytes**: operand plus result bytes of every aten op that
  launches work (views, allocations and metadata ops are free; a
  broadcast operand's repeated elements are read once).  In eager torch each
  such op reads its operands from and writes its result to device
  memory, so this is the reference's "top-level ops, fusion internals
  free" with every op its own fusion: an upper bound against a fused
  program (``c * 2 + 1`` is two ops here, one fusion in XLA);
* **collectives**: the ``c10d`` ops (all-gather, all-reduce,
  reduce-scatter, all-to-all; a ring hop's ``send`` as a
  collective-permute, its ``recv`` not counted, as the reference counts
  a ``-start`` and skips its ``-done``), each op's result bytes turned
  into per-rank link bytes with ``core/roofline.py::link_bytes``; the
  group size is read from the op's process group;
* **memory per rank**, under ``memory_analysis``' field names: the
  arguments' bytes (the local blocks of DTensors), the outputs', and the
  peak of the storage the call allocates and holds live at once
  (``temp_size_in_bytes``); the generated code's size is None.

There are no ``while_trips``: the step runs eagerly, so every loop body
is counted each time it runs, which is what the reference's trip
multiplier reconstructs.  The port's CUDA kernels are loaded through
``ctypes``, not registered with the dispatcher, so neither counter sees
them: count a step built with ``impl="reference"``, as the reference's
dry-run does.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from .roofline import CollectiveStats, link_bytes

__all__ = ["StepStats", "analyze_step", "MEMORY_FIELDS"]

MEMORY_FIELDS = ("temp_size_in_bytes", "argument_size_in_bytes",
                 "output_size_in_bytes", "generated_code_size_in_bytes")


@dataclass
class StepStats:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    coll_link_bytes: float = 0.0
    coll_counts: dict = field(default_factory=dict)
    coll_bytes: dict = field(default_factory=dict)
    memory: dict = field(default_factory=dict)

    def collective_stats(self) -> CollectiveStats:
        """The collectives alone, as ``core/roofline.py`` keeps them."""
        return CollectiveStats(dict(self.coll_counts), dict(self.coll_bytes),
                               self.coll_link_bytes)

    def add(self, other: "StepStats", mult: float = 1.0):
        self.flops += other.flops * mult
        self.hbm_bytes += other.hbm_bytes * mult
        self.coll_link_bytes += other.coll_link_bytes * mult
        for k, v in other.coll_counts.items():
            self.coll_counts[k] = self.coll_counts.get(k, 0) + v * mult
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + v * mult


# c10d op -> (the reference's collective name, index of the argument
# whose tensors are the result, index of the process group argument).
_C10D = {
    "allgather_": ("all-gather", 0, 2),
    "_allgather_base_": ("all-gather", 0, 2),
    "allgather_into_tensor_coalesced_": ("all-gather", 0, 2),
    "allreduce_": ("all-reduce", 0, 1),
    "allreduce_coalesced_": ("all-reduce", 0, 1),
    "reduce_scatter_": ("reduce-scatter", 0, 2),
    "_reduce_scatter_base_": ("reduce-scatter", 0, 2),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0, 2),
    "alltoall_": ("all-to-all", 0, 2),
    "alltoall_base_": ("all-to-all", 0, 2),
    "send": ("collective-permute", 0, 1),
}
# aten ops that launch no work: allocation, views the schema does not
# mark as such, metadata and host reads.  (Every ``prim`` op is metadata.)
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh",
         "lift_fresh_copy", "_local_scalar_dense", "set_", "resize_",
         "_unsafe_view", "_reshape_alias", "sym_size", "sym_stride",
         "sym_numel", "sym_storage_offset", "is_same_size"}


def _tensors(x, out=None) -> list:
    """The tensors in nested lists, tuples, dicts and dataclasses (an
    op's arguments and results, a step's state), in order."""
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    elif hasattr(x, "__dataclass_fields__"):
        for name in x.__dataclass_fields__:
            _tensors(getattr(x, name), out)
    return out


def _nbytes(ts) -> float:
    return float(sum(t.numel() * t.element_size() for t in ts))


def _read_bytes(ts) -> float:
    """Bytes of the distinct elements of each tensor: a broadcast
    (stride-0) dimension is read once."""
    total = 0
    for t in ts:
        n = t.element_size()
        for size, stride in zip(t.shape, t.stride()):
            if stride:
                n *= size
        total += n if t.numel() else 0
    return float(total)


def _group_size(pg, default: int) -> int:
    """The size of a c10d op's process group (a boxed ``ProcessGroup``);
    ``default`` where it names none."""
    try:
        return dist.ProcessGroup.unbox(pg).size()
    except (RuntimeError, TypeError):
        return default


def _local(t):
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _storage_bytes(tree) -> tuple[float, set]:
    """Bytes of the distinct storages under a tree's tensors (a DTensor's
    local block), and their keys."""
    seen, total = set(), 0.0
    for t in _tensors(tree):
        t = _local(t)
        if t.device.type == "meta" and not hasattr(t, "fake_mode"):
            continue
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total, seen


class _Counter(TorchDispatchMode):
    """Counts HBM bytes and collectives of every op it dispatches, and
    the storage the call allocates, live and at its peak."""

    def __init__(self, stats: StepStats, known: set, n_chips: int):
        super().__init__()
        self.stats = stats
        self.n_chips = n_chips
        self.known = set(known)     # argument storages: not temporaries
        self.live = 0.0
        self.peak = 0.0

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self.known:
                continue
            self.known.add(key)
            n = float(st.nbytes())
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)

    def _free(self, key, n):
        self.known.discard(key)
        self.live -= n

    def _collective(self, op: str, result: list, pg):
        raw = _nbytes(result)
        if raw == 0.0:
            return
        s = self.stats
        s.coll_counts[op] = s.coll_counts.get(op, 0) + 1
        s.coll_bytes[op] = s.coll_bytes.get(op, 0.0) + raw
        s.coll_link_bytes += link_bytes(op, raw, _group_size(pg, self.n_chips))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "c10d" and name in _C10D:
            op, res, pg = _C10D[name]
            result = _tensors(args[res])
            self._collective(op, result, args[pg])
            # operands and results: an all-reduce's tensors are both
            self.stats.hbm_bytes += _nbytes(_tensors((args, kwargs))) + (
                _nbytes(result) if op == "all-reduce" else 0.0)
        elif (ns == "aten" and name not in _FREE
              and not func.is_view):
            self.stats.hbm_bytes += (_read_bytes(_tensors((args, kwargs)))
                                     + _nbytes(_tensors(out)))
        self._track(out)
        return out


def analyze_step(fn, *args, n_chips: int = 1, **kw) -> StepStats:
    """Call ``fn(*args, **kw)`` once and count its work per rank (module
    docstring).  ``n_chips`` is the world the counts stand for; every
    number is this rank's, as the reference's per-device HLO; a
    collective whose group cannot be read counts as one over all of
    them, as the reference's default."""
    stats = StepStats()
    arg_bytes, arg_keys = _storage_bytes((args, kw))
    counter = _Counter(stats, arg_keys, n_chips)
    flops = FlopCounterMode(display=False)
    with flops, counter:
        out = fn(*args, **kw)
    stats.flops = float(flops.get_total_flops())
    out_bytes, _ = _storage_bytes(out)
    stats.memory = {"temp_size_in_bytes": int(counter.peak),
                    "argument_size_in_bytes": int(arg_bytes),
                    "output_size_in_bytes": int(out_bytes),
                    "generated_code_size_in_bytes": None}
    return stats
