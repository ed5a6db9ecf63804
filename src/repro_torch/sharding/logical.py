"""Logical-axis sharding: named tensor axes decoupled from the mesh (the
reference's ``repro.sharding.logical``).

Tensor axes are named logically ("batch", "embed", "heads", ...).
:func:`axis_rules` installs a rule set that maps logical names to mesh
axes ("data", "model", "pod") for the current mesh; with no rules
installed every spec is replicated, so the same code runs on one card and
on a 512-rank mesh unchanged.  The rules give the parameter, optimizer,
cache and input specs (:mod:`repro_torch.sharding.rules`) and, through
the mesh's model axis, the attention's head layout; the model's
activations are plain tensors and carry no annotation.

Rules are divisibility-aware: a logical axis binds to a mesh axis only if
the dimension divides by the mesh axis's size, otherwise it replicates
(``kv_heads=8`` beside a 16-way model axis: the KV projections replicate,
the Q heads shard).  A mesh axis bound twice keeps its first binding.

A spec is a :class:`PartitionSpec`: one entry per tensor dimension, each
``None``, a mesh-axis name or a tuple of names (the reference's
``jax.sharding.PartitionSpec``).  :func:`placements` turns it into the
``DTensor`` placements of a :class:`~torch.distributed.device_mesh.
DeviceMesh`.  Everything here reads only a mesh's axis names and shape
(``mesh_dim_names``, ``shape``), so a mesh over the ``fake`` process
group serves it at production size in one process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

try:
    from torch.distributed.tensor import DTensor
except ImportError:             # a build without torch.distributed
    DTensor = ()

__all__ = ["PartitionSpec", "NamedSharding", "axis_rules", "current_rules",
           "constrain", "logical_to_mesh", "spec_for", "named_sharding",
           "placements", "mesh_axis_sizes", "is_dtensor", "arange_like",
           "map_local", "head_placements", "from_local"]

MeshAxes = Union[str, Tuple[str, ...], None]

_state = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dimension: ``None`` (replicated), a mesh-axis
    name, or a tuple of mesh-axis names (sharded over their product)."""

    def __new__(cls, *parts: MeshAxes) -> "PartitionSpec":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def is_dtensor(x) -> bool:
    """True for a ``DTensor`` (the dry run's sharded inputs); the model's
    DTensor-only forms branch on it, so a plain tensor keeps its path."""
    return isinstance(x, DTensor)


def arange_like(t: torch.Tensor, n: int, dtype=torch.long) -> torch.Tensor:
    """``0 .. n-1`` on ``t``'s device.  A tensor subclass (a ``DTensor``:
    replicated; a fake tensor) makes them as it makes ``t``, so that the
    positions, and the masks built from them, are made as ``t`` is (in the
    dry run: fake, no host tensor); a plain tensor takes ``arange``."""
    if type(t) is not torch.Tensor:
        return t.new_ones((n,), dtype=dtype).cumsum(0, dtype=dtype) - 1
    return torch.arange(n, dtype=dtype, device=t.device)


def map_local(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an ``fn`` that maps every row (last axis) of ``x`` on
    its own to a row of a result of ``x``'s shape.  A ``DTensor`` ``x``
    (its partial sums reduced, its rows gathered whole first) runs ``fn``
    on its local shard and keeps its layout: for the ops ``DTensor`` has no
    sharding rule for (``searchsorted``, a stable sort's scatter)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate

    last = x.dim() - 1
    pl = tuple(Replicate() if p.is_partial() or (p.is_shard() and p.dim in
                                                (last, -1)) else p
               for p in x.placements)
    if pl != tuple(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return from_local(fn(x.to_local()), x.device_mesh, pl, x.shape)


def head_placements(q) -> Tuple[tuple, tuple]:
    """``(head, kv)``: the placements of a ``DTensor`` ``q (B, KV, G, ...)``
    with only its batch and head dims (0-2) kept on their mesh axes, and
    of a ``k (B, KV, ...)`` laid out alike (dims 0-1).  Work local to a
    (batch, head) row runs on these shards with no collective."""
    from torch.distributed.tensor import Replicate

    head = tuple(p if p.is_shard() and p.dim in (0, 1, 2) else Replicate()
                 for p in q.placements)
    kv = tuple(p if p.is_shard() and p.dim < 2 else Replicate()
               for p in head)
    return head, kv


def from_local(local: torch.Tensor, mesh, pl: tuple, shape):
    """A ``DTensor`` of global ``shape`` (contiguous) laid out by ``pl``
    whose local shard is ``local``."""
    stride, n = [], 1
    for d in reversed(shape):
        stride.insert(0, n)
        n *= d
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=shape, stride=tuple(stride))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a mesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def placements(spec: PartitionSpec, mesh) -> tuple:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: ``Shard(d)`` on
    every mesh axis that tensor dimension ``d`` binds, ``Replicate()`` on
    the others.  A dimension over several axes is split in mesh order."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, ax in enumerate(spec):
        for a in (() if ax is None else (ax,) if isinstance(ax, str)
                  else ax):
            out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def current_rules() -> Optional[Dict[str, MeshAxes]]:
    return getattr(_state, "rules", None)


def _current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def axis_rules(rules: Dict[str, MeshAxes], mesh=None):
    """Install logical -> mesh axis rules (and optionally the mesh) for the
    current thread."""
    prev_rules = getattr(_state, "rules", None)
    prev_mesh = getattr(_state, "mesh", None)
    _state.rules = dict(rules)
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.rules = prev_rules
        _state.mesh = prev_mesh


def _axis_size(mesh, axes: MeshAxes) -> int:
    if mesh is None or axes is None:
        return 1
    sizes = mesh_axis_sizes(mesh)
    size = 1
    for a in ((axes,) if isinstance(axes, str) else axes):
        size *= sizes.get(a, 1)
    return size


def logical_to_mesh(names: Sequence[Optional[str]],
                    shape: Optional[Sequence[int]] = None,
                    rules: Optional[Dict[str, MeshAxes]] = None,
                    mesh=None) -> PartitionSpec:
    """Map logical axis names to a :class:`PartitionSpec` under the active
    rules.  ``shape`` (if given) turns on the divisibility check: an axis
    whose dimension does not divide by the bound mesh-axis size
    replicates.  Of two logical axes that bind one mesh axis, only the
    first keeps it."""
    rules = rules if rules is not None else current_rules()
    mesh = mesh if mesh is not None else _current_mesh()
    if rules is None:
        return PartitionSpec(*([None] * len(names)))
    used = set()
    out = []
    for i, n in enumerate(names):
        ax = rules.get(n) if n is not None else None
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        if any(a in used for a in axes):
            out.append(None)
            continue
        if shape is not None:
            sz = _axis_size(mesh, axes)
            if sz > 1 and shape[i] % sz != 0:
                out.append(None)
                continue
        used.update(axes)
        out.append(ax if isinstance(ax, str) else axes)
    return PartitionSpec(*out)


def spec_for(names: Sequence[Optional[str]],
             shape: Optional[Sequence[int]] = None) -> PartitionSpec:
    return logical_to_mesh(names, shape)


def constrain(x: torch.Tensor, names: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """Lay ``x`` out by logical names under the installed rules and mesh.
    A plain tensor is one global view and comes back unchanged (the
    reference's meaning without a mesh); a ``DTensor`` is redistributed to
    the spec's placements."""
    rules, mesh = current_rules(), _current_mesh()
    if rules is None or mesh is None or not is_dtensor(x):
        return x
    spec = logical_to_mesh(names, x.shape, rules, mesh)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


def named_sharding(mesh, names: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None,
                   rules: Optional[Dict[str, MeshAxes]] = None
                   ) -> NamedSharding:
    return NamedSharding(mesh, logical_to_mesh(names, shape, rules, mesh))
