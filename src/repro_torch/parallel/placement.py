"""Specs on a ``DeviceMesh``: the counterpart of ``NamedSharding``.

A spec ``P`` names, per tensor dimension, the mesh axes it is split
over, major to minor.  Its placements put a ``Shard(d)`` on every mesh
dimension that tensor dimension ``d`` names and ``Replicate()`` on the
others; two mesh dimensions on one tensor dimension split it in mesh
order, the first the major one, which is JAX's order for
``P(("data", "model"))``.  ``local_part`` cuts a rank's block out of a
full tensor by the same rule, with no communication; ``distribute`` and
``gather`` go through ``torch.distributed.tensor``.  ``mesh_group``
gives the process group of the ranks that differ only along some mesh
axes (one group per such set, made by every rank in the same order, as
``torch.distributed`` requires).
"""
from __future__ import annotations

import itertools

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from .act_sharding import P

__all__ = ["axes_of", "placements", "local_part", "distribute", "gather",
           "gather_dim", "spec_of", "from_local", "mesh_group",
           "mesh_subgroup", "group_size_rank", "block_index"]

_GROUPS: dict = {}


def axes_of(entry) -> tuple:
    """The mesh axes one spec entry names."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def _check_order(mesh, names: tuple):
    order = [mesh.mesh_dim_names.index(n) for n in names]
    if order != sorted(order):
        raise ValueError(f"spec entry {names} is not in the mesh's axis "
                         f"order {mesh.mesh_dim_names}")


def placements(spec: P, mesh) -> list:
    """One placement per mesh dimension."""
    out = [Replicate()] * mesh.ndim
    for d, e in enumerate(spec):
        names = axes_of(e)
        _check_order(mesh, names)
        for n in names:
            out[mesh.mesh_dim_names.index(n)] = Shard(d)
    return out


def block_index(mesh, names: tuple) -> tuple[int, int]:
    """(this rank's block, the block count) along the mesh axes
    ``names``, major to minor."""
    coord = mesh.get_coordinate()
    idx, total = 0, 1
    for n in names:
        m = mesh.mesh_dim_names.index(n)
        idx = idx * mesh.shape[m] + coord[m]
        total *= mesh.shape[m]
    return idx, total


def local_part(full: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a view)."""
    out = full
    for d, e in enumerate(spec):
        names = axes_of(e)
        if not names:
            continue
        i, n = block_index(mesh, names)
        size = full.shape[d] // n
        out = out.narrow(d, i * size, size)
    return out


def distribute(full: torch.Tensor, mesh, spec: P) -> DTensor:
    """``full`` (the same on every rank) as a DTensor under ``spec``, in
    storage of its own (a step that updates it in place never writes
    into ``full``).  Each rank cuts its block from its own copy
    (``src_data_rank=None``): no communication."""
    dt = distribute_tensor(full, mesh, placements(spec, mesh),
                           src_data_rank=None)
    local = dt.to_local()
    if is_fake(local) or local.untyped_storage().data_ptr() == \
            full.untyped_storage().data_ptr():
        # A fake tensor has no storage to share; its block is a new
        # tensor, like the copy of a real one.
        dt = from_local(local.clone(), mesh, spec)
    return dt


def from_local(local: torch.Tensor, mesh, spec: P) -> DTensor:
    """A DTensor from this rank's block (no communication)."""
    return DTensor.from_local(local, mesh, placements(spec, mesh),
                              run_check=False)


def spec_of(t: DTensor) -> P:
    """The spec of a DTensor's placements."""
    entries = [[] for _ in range(t.ndim)]
    for name, pl in zip(t.device_mesh.mesh_dim_names, t.placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(name)
    return P(*entries)


def gather(t):
    """The full tensor of a DTensor (every rank must call); a plain
    tensor as it is.  Each split tensor dimension is gathered in one
    all-gather over the group of all the mesh axes it names (the
    flattened dimensions DTensor's own ``full_tensor`` would gather one
    after another)."""
    if not isinstance(t, DTensor):
        return t
    mesh, out = t.device_mesh, t.to_local()
    for d, e in enumerate(spec_of(t)):
        out = gather_dim(out, d, mesh_group(mesh, e))
    return out


def gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of ``t`` on every rank of ``group``, in group order,
    laid end to end along ``dim`` (``t`` itself for no group)."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim)


def mesh_group(mesh, names) -> dist.ProcessGroup | None:
    """The group of the ranks that share this rank's coordinates on
    every mesh axis but ``names``; None for no axes.  A group ranks its
    members by global rank, which on a mesh laid out in rank order (as
    ``launch/mesh.py`` makes them) is the block order of ``names``."""
    names = tuple(n for n in mesh.mesh_dim_names if n in axes_of(names))
    if not names:
        return None
    if len(names) == 1:
        return mesh.get_group(names[0])
    key = (id(mesh), names)
    if key not in _GROUPS:
        group, _ = dist.new_subgroups_by_enumeration(
            _rank_lists(mesh, names))
        _GROUPS[key] = (mesh, group)
    return _GROUPS[key][1]


def mesh_subgroup(mesh, name: str, parts: int) -> dist.ProcessGroup:
    """The group of the ranks in this rank's part when the ranks along
    the mesh axis ``name`` are cut into ``parts`` runs of consecutive
    coordinates (every rank makes every such group, in one order)."""
    key = (id(mesh), name, parts)
    if key not in _GROUPS:
        lists = []
        for ranks in _rank_lists(mesh, (name,)):
            n = len(ranks) // parts
            lists += [ranks[i * n:(i + 1) * n] for i in range(parts)]
        group, _ = dist.new_subgroups_by_enumeration(lists)
        _GROUPS[key] = (mesh, group)
    return _GROUPS[key][1]


def _rank_lists(mesh, names: tuple) -> list:
    """The ranks of every group along the mesh axes ``names``, each in
    the block order of ``names``, the groups in the order of the other
    axes' coordinates: plain Python on the mesh's rank list (no tensor
    op, so a fake tensor mode cannot intercept it)."""
    dims = [mesh.mesh_dim_names.index(n) for n in names]
    rest = [d for d in range(mesh.ndim) if d not in dims]
    ranks = mesh.mesh.tolist()
    out = []
    for outer in itertools.product(*(range(mesh.shape[d]) for d in rest)):
        group = []
        for inner in itertools.product(*(range(mesh.shape[d])
                                         for d in dims)):
            coord = [0] * mesh.ndim
            for d, i in zip(rest + dims, outer + inner):
                coord[d] = i
            r = ranks
            for i in coord:
                r = r[i]
            group.append(r)
        out.append(group)
    return out


def group_size_rank(group) -> tuple[int, int]:
    """(size, this rank's index) of a group; (1, 0) for None."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)
