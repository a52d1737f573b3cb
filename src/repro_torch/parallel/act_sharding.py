"""Partition specs and the activation sharding hooks (counterpart of
``repro/parallel/act_sharding.py``).

``P`` is the port's ``PartitionSpec``: a tuple with one entry per tensor
dimension, each ``None``, a mesh axis name or a tuple of names (major to
minor), normalised as JAX normalises its specs (an empty tuple is
``None``, a one-name tuple the name), so a spec compares entry for entry
with the reference's.

``ActivationRules`` keeps the reference's spec-fixing arithmetic (trim
to the array's rank, drop the entries the mesh does not divide).  The
reference's ``shard_act`` constrains an activation to its spec for
GSPMD; the port has no such hook: each rank runs its own body on its
own blocks.  The context ``activation_rules`` installs is how the
models find the sharded step they run in: the MoE dispatch reads the
mesh and the batch axes of the rank's rows (``models/moe.py``), and the
dense family's sharded steps read the ``Split`` of their projections,
heads and cache (``parallel/split.py``; None elsewhere, and the other
families run weight-gathered, ROADMAP A.12 c).
"""
from __future__ import annotations

import contextlib
import contextvars

__all__ = ["P", "activation_rules", "ActivationRules",
           "data_shards", "mesh_sizes", "current_rules"]


def _entry(e):
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        if not e:
            return None
        return e[0] if len(e) == 1 else e
    return e


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self) -> str:
        return "P" + (super().__repr__() if len(self) != 1
                      else f"({self[0]!r})")


def mesh_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (its ``mesh_dim_names``),
    a ``MeshDescriptor`` or a dict already of that form."""
    if mesh is None:
        return {}
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None) or getattr(mesh, "axes")
    return dict(zip(names, tuple(mesh.shape)))


_CTX: contextvars.ContextVar = contextvars.ContextVar("act_rules",
                                                      default=None)


class ActivationRules:
    """name -> P; unknown names pass through unsharded.  ``batch_axes``
    names the mesh axes the rank's rows are split over (the fitted batch
    spec's entry, ``()`` when every rank runs every row); None reads it
    from the ``"hidden"`` spec.  ``split`` is the dense sharded step's
    ``parallel.split.Split``, or None."""

    def __init__(self, specs: dict, mesh=None, batch_axes=None,
                 split=None):
        self.specs = specs
        self.mesh = mesh
        self.split = split
        if batch_axes is None:
            hidden = specs.get("hidden")
            batch_axes = hidden[0] if hidden else None
        self.batch_axes = ((batch_axes,) if isinstance(batch_axes, str)
                           else tuple(batch_axes or ()))

    def spec_for(self, shape, name: str) -> P | None:
        """The reference's fixed spec of an activation of ``shape``: the
        named spec trimmed (or padded with None) to the rank, entries
        whose dimension the mesh axes do not divide dropped."""
        spec = self.specs.get(name)
        if spec is None:
            return None
        sizes = mesh_sizes(self.mesh)
        entries = list(spec)[:len(shape)]
        entries += [None] * (len(shape) - len(entries))
        fixed = []
        for dim, e in zip(shape, entries):
            names = (e,) if isinstance(e, str) else tuple(e or ())
            total = 1
            for n in names:
                total *= sizes.get(n, 1)
            fixed.append(e if (total and dim % total == 0) else None)
        return P(*fixed)


@contextlib.contextmanager
def activation_rules(rules: ActivationRules | None):
    tok = _CTX.set(rules)
    try:
        yield
    finally:
        _CTX.reset(tok)


def current_rules() -> ActivationRules | None:
    return _CTX.get()


def data_shards() -> int:
    """Product of the batch-carrying mesh axes in the active context
    (1 outside any mesh) -- the block count for hierarchical dispatch."""
    rules = _CTX.get()
    if rules is None or rules.mesh is None:
        return 1
    sizes = mesh_sizes(rules.mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)
