"""Partition specs and the activation sharding hooks (counterpart of
``repro/parallel/act_sharding.py``).

``P`` is the port's ``PartitionSpec``: a tuple with one entry per tensor
dimension, each ``None``, a mesh axis name or a tuple of names (major to
minor), normalised as JAX normalises its specs (an empty tuple is
``None``, a one-name tuple the name), so a spec compares entry for entry
with the reference's.

``ActivationRules`` keeps the reference's spec-fixing arithmetic (trim
to the array's rank, drop the entries the mesh does not divide).  Under
the port's sharded steps (``launch/steps.py``) every rank holds the rows
of its batch block, which is what every ``"hidden"`` spec says, so
``shard_act`` returns its input unchanged: the models do not call it
yet, and the split execution of the activation-gathered classes that
would read these specs is ROADMAP A.12 (c).  The context
``activation_rules`` installs is also how the MoE dispatch finds the
mesh and the batch axes of the rank's rows (``models/moe.py``).
"""
from __future__ import annotations

import contextlib
import contextvars

__all__ = ["P", "shard_act", "activation_rules", "ActivationRules",
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
    from the ``"hidden"`` spec."""

    def __init__(self, specs: dict, mesh=None, batch_axes=None):
        self.specs = specs
        self.mesh = mesh
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

    def constrain(self, x, name: str):
        """``x`` as it is: each rank already holds its block (see the
        module docstring)."""
        return x


@contextlib.contextmanager
def activation_rules(rules: ActivationRules | None):
    tok = _CTX.set(rules)
    try:
        yield
    finally:
        _CTX.reset(tok)


def current_rules() -> ActivationRules | None:
    return _CTX.get()


def shard_act(x, name: str):
    rules = _CTX.get()
    if rules is None:
        return x
    return rules.constrain(x, name)


def data_shards() -> int:
    """Product of the batch-carrying mesh axes in the active context
    (1 outside any mesh) -- the block count for hierarchical dispatch."""
    rules = _CTX.get()
    if rules is None or rules.mesh is None:
        return 1
    sizes = mesh_sizes(rules.mesh)
    return sizes.get("pod", 1) * sizes.get("data", 1)
