"""Checkpointing with atomic commit and async save, in the on-disk layout
of ``repro/checkpoint/store.py``, so a checkpoint written by either
package restores into the other:

    <dir>/step_00000120/
        manifest.json        # tree structure, shapes, dtypes, step
        arrays/leaf_00000.npy ...
        COMMITTED

Leaves are numbered in ``jax.tree.flatten`` order: dict keys sorted,
tuples and lists in order, a dataclass's fields in order (``Q8State`` is
(q, scale)), ``None`` holding no leaf.  Arrays are saved as full values.
The manifest and then the ``COMMITTED`` marker are written last and the
directory is renamed into place, so a checkpoint without the marker is
ignored by ``latest_step`` (crash-safe).  ``AsyncCheckpointer`` copies
to host memory synchronously and writes in a background thread.

bfloat16 has no numpy type without ``ml_dtypes``, which the machine with
the card lacks.  A bf16 leaf is written as its raw 2-byte words
(``uint16``) with the manifest dtype ``"bfloat16"``, which ``repro``'s
restore re-views by item size; a leaf the manifest calls ``"bfloat16"``
(``repro`` writes them as raw ``|V2`` data) is read as 16-bit words and
viewed as ``torch.bfloat16``.  Both directions are bit for bit.

Under a mesh (``launch/steps.py::build_step``) the leaves are DTensors:
every rank gathers each leaf whole for the snapshot (a collective: all
ranks save together) and rank 0 alone writes it.  A restore into a tree
of DTensors reads the full arrays on every rank and keeps each rank's
blocks under the placements of the matching leaf.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer", "tree_leaves", "tree_unflatten"]

_MARKER = "COMMITTED"


def _children(node):
    """A container's children in ``jax.tree.flatten`` order, or None for
    a leaf."""
    if isinstance(node, dict):
        return [node[k] for k in sorted(node)]
    if isinstance(node, (tuple, list)):
        return list(node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [getattr(node, f.name) for f in dataclasses.fields(node)]
    return None


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, tuples, lists and dataclasses, in
    ``jax.tree.flatten`` order (``None`` holds no leaf)."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for kid in kids for leaf in tree_leaves(kid)]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` with its leaves taken from ``leaves``
    in order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (tuple, list)):
            return type(node)(build(x) for x in node)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: build(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def _structure(node) -> str:
    """A readable rendering of the tree's structure, ``*`` per leaf."""
    if node is None:
        return "None"
    if isinstance(node, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(node[k])}"
                               for k in sorted(node)) + "}"
    if isinstance(node, (tuple, list)):
        return "(" + ", ".join(_structure(x) for x in node) + ")"
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return type(node).__name__ + "(" + ", ".join(
            _structure(getattr(node, f.name))
            for f in dataclasses.fields(node)) + ")"
    return "*"


def _writes() -> bool:
    """True where this process writes checkpoints: rank 0 of a process
    group, or a process with none."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(numpy array to write, manifest dtype) of one leaf; a DTensor's
    whole value."""
    if isinstance(leaf, DTensor):
        from ..parallel.placement import gather
        leaf = gather(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _snapshot(tree) -> tuple[list, str]:
    """(host leaves as (array, dtype) pairs, structure string)."""
    return [_to_host(leaf) for leaf in tree_leaves(tree)], _structure(tree)


def _write(directory: str, step: int, host: list, structure: str,
           keep: int) -> str:
    flat = {f"leaf_{i:05d}": pair for i, pair in enumerate(host)}
    path = os.path.join(directory, f"step_{step:08d}")
    tmp = path + ".tmp"
    os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
    for k, (arr, _) in flat.items():
        np.save(os.path.join(tmp, "arrays", k + ".npy"), arr)
    manifest = {
        "step": step,
        "treedef": structure,
        "n_leaves": len(host),
        "shapes": {k: list(a.shape) for k, (a, _) in flat.items()},
        "dtypes": {k: dt for k, (_, dt) in flat.items()},
        "time": time.time(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    with open(os.path.join(tmp, _MARKER), "w") as f:
        f.write("ok")
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    _gc(directory, keep)
    return path


def save_checkpoint(directory: str, step: int, tree, *,
                    keep: int = 3) -> str:
    """Blocking save; returns the checkpoint path (written by rank 0
    only under a process group)."""
    host, structure = _snapshot(tree)
    path = os.path.join(directory, f"step_{step:08d}")
    return _write(directory, step, host, structure, keep) if _writes() \
        else path


def _gc(directory: str, keep: int):
    steps = sorted(_committed_steps(directory))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def _committed_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, _MARKER)):
                out.append(int(name[len("step_"):]))
    return out


def latest_step(directory: str) -> int | None:
    steps = _committed_steps(directory)
    return max(steps) if steps else None


def _load_leaf(path: str, want: str) -> torch.Tensor:
    arr = np.load(path)
    if want == "bfloat16":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"{path}: a bfloat16 leaf stored as {arr.dtype}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != want:
        raise ValueError(f"{path}: stored as {arr.dtype}, manifest says "
                         f"{want}; only bfloat16 is re-viewed")
    return torch.from_numpy(arr)


def restore_checkpoint(directory: str, like, *, step: int | None = None):
    """Restore into the structure of ``like``: each leaf becomes a tensor
    with the stored dtype and values, on the device of the matching leaf
    of ``like`` (the CPU where that leaf is not a tensor).  ``like`` may
    hold a leading part of the saved leaves, as ``repro``'s restore
    allows: ``(params, {})`` reads the params of a ``(params, opt_state)``
    checkpoint.  Returns (tree, step).  Raises if ``like`` holds more
    leaves than the checkpoint or a shape differs."""
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like_leaves = tree_leaves(like)
    if manifest["n_leaves"] < len(like_leaves):
        raise ValueError(f"{path} holds {manifest['n_leaves']} leaves, the "
                         f"tree {len(like_leaves)}")
    restored = []
    for i, ref in enumerate(like_leaves):
        key = f"leaf_{i:05d}"
        t = _load_leaf(os.path.join(path, "arrays", key + ".npy"),
                       manifest["dtypes"][key])
        is_tensor = isinstance(ref, torch.Tensor)
        shape = list(ref.shape if is_tensor else np.shape(ref))
        if list(t.shape) != shape:
            raise ValueError(f"{path}: {key} has shape {list(t.shape)}, "
                             f"the tree {shape}")
        device = ref.device if is_tensor else "cpu"
        if isinstance(ref, DTensor):
            from ..parallel.placement import from_local, local_part, spec_of
            spec, mesh = spec_of(ref), ref.device_mesh
            restored.append(from_local(local_part(
                t.to(device), mesh, spec).contiguous(), mesh, spec))
        else:
            restored.append(t.to(device))
    return tree_unflatten(like, restored), step


class AsyncCheckpointer:
    """Snapshot-then-write-in-background checkpointer.

    ``save`` blocks only for the device->host copy; the serialization
    happens on a worker thread.  ``wait`` joins the in-flight write
    (called before exit and before starting a save for the same dir).
    """

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_saved: int | None = None

    def save(self, step: int, tree):
        self.wait()
        host, structure = _snapshot(tree)
        if not _writes():
            return

        def work():
            _write(self.directory, step, host, structure, self.keep)
            self.last_saved = step

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
