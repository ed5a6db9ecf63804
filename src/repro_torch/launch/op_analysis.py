"""Roofline terms of a step from the ops it runs on each device's local
shards (the reference's ``repro.launch.hlo_analysis``, which parses XLA's
compiled SPMD program; torch has no such program).

:class:`OpAnalysis` is a dispatch mode that records every aten op the step
runs on plain tensors.  On ``DTensor`` operands it declines
(``NotImplemented``), so ``DTensor`` runs its sharding rules and issues the
local op on each operand's local shard -- and that op, with the functional
collectives of any redistribution, comes back to the mode: the counts are
per device, as the reference's.  (A mode that handled the ``DTensor`` op
itself would see the global product.)  Ops on another fake-tensor mode's
tensors are ``DTensor``'s own shape propagation on global shapes and are
not counted.

The keys of :func:`repro.launch.hlo_analysis.parse_hlo_stats`:

  * ``dot_flops``: matrix products (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, what ``matmul`` / ``einsum`` / ``linear`` and the
    attention ops reach), by ``torch.utils.flop_counter``'s formulas on
    the local shapes -- on one device the count of ``FlopCounterMode``;
  * ``traffic_bytes``: operand plus result bytes of every op that
    materializes a result (views are free).  Eager torch fuses nothing, so
    every intermediate goes through memory: an upper bound of XLA's count,
    whose fusions keep most elementwise chains in registers;
  * ``coll:<type>`` and ``collective_bytes``: the functional collectives
    (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``broadcast``), sized by the local result, as the reference sizes
    them.  On a CPU mesh ``DTensor`` runs a shard-to-shard all-to-all as
    an all-gather and a chunk; that all-gather counts as one all-to-all of
    the chunk's bytes.

Beside them, :attr:`OpAnalysis.peak_bytes`: the peak of live bytes that
the recorded ops allocated (storages tracked until freed; the step's
arguments, registered with :meth:`OpAnalysis.add_arguments`, are not
counted), the dry run's temp column.

Plain tensors that the step makes from no input (position ids, RoPE
tables, masks) are made whole on every device, as replicated tensors are:
their ops are counted at their full size -- but for ops on one or two
plain tensors of fewer than 4096 elements each, which are ``DTensor``'s
own index arithmetic and are not counted.  ``max_plain_bytes`` bounds
what a plain op may make (a rerun on ``meta`` sizes it); the integer ops
that ``DTensor`` issues itself while it shards or plans a redistribution
(``chunk``, ``cat``, ``arange`` on index tensors) make no sharded data
and are counted without that rerun.

With ``trip_count`` the analysis counts a loop of like iterations as the
reference counts a ``while`` body, once times its trip count:
:func:`repro_torch.loops.scan` runs iteration 0, has it counted ``n``
times (:meth:`OpAnalysis.snapshot`, :meth:`OpAnalysis.count_again`) and
stands the other iterations' outputs in (:meth:`OpAnalysis.stand_in`):
live bytes hold them as buffers of their own, and no traffic is counted
for making them.
"""

from __future__ import annotations

import sys
import weakref
from collections import defaultdict
from typing import Dict, Iterable

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map
from torch.utils.flop_counter import flop_registry

__all__ = ["OpAnalysis", "parse_op_stats", "op_collectives"]

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
    "broadcast_": "broadcast", "shard_dim_alltoall": "all-to-all",
}
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                    "c10d_functional", "_dtensor")
# a collective's completion, and its autograd wrapper: alias their
# operand, move nothing
_WAITS = ("wait_tensor", "_wrap_tensor_autograd")
# DTensor's CPU fallback for a shard-to-shard all-to-all
_CPU_ALLTOALL = "shard_dim_alltoall"
_SMALL = 4096
# frames that lie between an op and the code that issued it: torch's own
# (dispatch, functional wrappers) and this module's
_DISPATCH_MODULES = ("torch.", __name__)


def _tensors(tree) -> list:
    """The tensors of an op's arguments or result (nested tuples, lists
    and dicts)."""
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            todo.extend(reversed(x))
        elif isinstance(x, dict):
            todo.extend(reversed(list(x.values())))
    return out


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _issued_by_dtensor() -> bool:
    """True if the op being dispatched was issued by ``DTensor``'s own
    code (its sharding, its redistribution planner), not by the step: the
    nearest frame outside torch's dispatch is ``DTensor``'s."""
    f = sys._getframe(1)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("torch.distributed.tensor"):
            return True
        if not mod.startswith(_DISPATCH_MODULES):
            return False
        f = f.f_back
    return False


def _index_op(kwargs, ins) -> bool:
    """An op on integer (or boolean) tensors that makes no float tensor
    and that ``DTensor`` issued: index arithmetic, no sharded data."""
    dtype = kwargs.get("dtype")
    if dtype is not None and (dtype.is_floating_point or dtype.is_complex):
        return False
    if any(t.is_floating_point() or t.is_complex() for t in ins):
        return False
    return _issued_by_dtensor()


def _in_cpu_alltoall() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == _CPU_ALLTOALL:
            return True
        f = f.f_back
    return False


class OpAnalysis(TorchDispatchMode):
    """Records the ops of its context (module docstring).

    ``fake_mode`` is the fake-tensor mode of the local shards, if any:
    tensors of any other fake mode are shape propagation and are skipped.
    ``max_plain_bytes`` bounds a plain (not fake) tensor that an op may
    make: past it the op raises, naming itself, before a dry run of a
    production shape allocates host memory that a device would hold.
    ``trip_count`` counts :func:`repro_torch.loops.scan`'s loops by trip
    count; ``global_counter`` (a ``FlopCounterMode`` of the same run) is
    scaled alike."""

    def __init__(self, fake_mode=None, max_plain_bytes=None,
                 trip_count: bool = False, global_counter=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.max_plain_bytes = max_plain_bytes
        self.trip_count = trip_count
        self.global_counter = global_counter
        self.stats: Dict[str, float] = defaultdict(float)
        self.live_bytes = 0
        self.peak_bytes = 0
        self._known = weakref.WeakValueDictionary()
        self.read = set()        # storages an op has read
        self._standing_in = False
        self._dtensor_traffic = 0.0

    # -- trip counts --------------------------------------------------------
    def snapshot(self):
        """The counts so far, for :meth:`count_again`."""
        glob = self.global_counter
        flops = ({m: dict(d) for m, d in glob.flop_counts.items()}
                 if glob is not None else {})
        return dict(self.stats), flops, self._dtensor_traffic

    def count_again(self, mark, times: int) -> None:
        """Count what was recorded since ``mark`` (:meth:`snapshot`)
        ``times`` more times: a loop body's other iterations.  The traffic
        of ``DTensor``'s own ops on plain tensors is not counted again: it
        plans a layout once and caches the plan, so an unrolled loop runs
        them in its first iteration only."""
        stats, flops, dtensor_traffic = mark
        for k, v in list(self.stats.items()):
            self.stats[k] = v + times * (v - stats.get(k, 0.0))
        self.stats["traffic_bytes"] -= times * (
            self._dtensor_traffic - dtensor_traffic)
        if self.global_counter is not None:
            for m, d in self.global_counter.flop_counts.items():
                before = flops.get(m, {})
                for op, v in list(d.items()):
                    d[op] = v + times * (v - before.get(op, 0))

    def stand_in(self, tree):
        """Empty tensors of ``tree``'s shapes, placements and dtypes (a
        skipped iteration's outputs): live buffers, no traffic."""
        from repro_torch.tree import tree_map

        self._standing_in = True
        try:
            return tree_map(lambda t: torch.empty_like(t)
                            if isinstance(t, torch.Tensor) else t, tree)
        finally:
            self._standing_in = False

    # -- memory -----------------------------------------------------------
    def add_arguments(self, tensors: Iterable[torch.Tensor]) -> None:
        """Register the step's inputs (local shards): their storages are
        not the step's allocations."""
        for t in tensors:
            self._known[_storage_key(t)] = t.untyped_storage()

    def read_bytes(self, tensors: Iterable[torch.Tensor]) -> int:
        """The bytes of ``tensors`` (each storage once) that some recorded
        op read: the arguments a step uses (``jit`` prunes the others)."""
        total, seen = 0, set()
        for t in tensors:
            key = _storage_key(t)
            if key in self.read and key not in seen:
                seen.add(key)
                total += _nbytes(t)
        return total

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known:
            return
        n = st.nbytes()
        self._known[key] = st
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    # -- dispatch -----------------------------------------------------------
    def _foreign(self, ts) -> bool:
        """Tensors (or an active fake mode) of another fake mode: DTensor's
        shape propagation."""
        ambient = torch._C._get_dispatch_mode(
            torch._C._TorchDispatchModeKey.FAKE)
        if ambient is not None and ambient is not self.fake_mode:
            return True
        return any(isinstance(t, FakeTensor) and t.fake_mode is not
                   self.fake_mode for t in ts)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented    # DTensor issues the local ops
        ins = _tensors((args, kwargs))
        if self._foreign(ins):
            return func(*args, **kwargs)
        if self._standing_in:
            out = func(*args, **kwargs)
            for t in _tensors(out):
                self._track(t)
            return out
        self.read.update(_storage_key(t) for t in ins)
        if self._small_plain(func, ins):
            return func(*args, **kwargs)
        if (func._overloadpacket not in flop_registry
                and func is not torch.ops.prim.device.default):
            with self:                       # as FlopCounterMode
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        if self.max_plain_bytes is not None:
            self._check_plain(func, args, kwargs, ins)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if outs and not self._foreign(outs):
            self._record(func, args, kwargs, ins, outs, out)
        return out

    @staticmethod
    def _small_plain(func, ins) -> bool:
        """An op on one or two plain tensors of fewer than ``_SMALL``
        elements each (DTensor's own index arithmetic; a broadcast of two
        such makes at most ``_SMALL ** 2``): not counted."""
        return (0 < len(ins) <= 2 and func.namespace not in _COLL_NAMESPACES
                and all(not isinstance(t, FakeTensor) and t.numel() < _SMALL
                        for t in ins))

    def _check_plain(self, func, args, kwargs, ins) -> None:
        """Raise before an op on plain tensors makes one larger than
        ``max_plain_bytes`` (its output shapes from a run on ``meta``);
        ``DTensor``'s index arithmetic is let through unchecked."""
        if (any(isinstance(t, FakeTensor) for t in ins)
                or _index_op(kwargs, ins)):
            return
        to_meta = lambda x: x.to("meta") if isinstance(x, torch.Tensor) else x
        margs, mkw = tree_map(to_meta, (args, kwargs))
        if "device" in mkw:
            mkw["device"] = torch.device("meta")
        try:
            outs = _tensors(func(*margs, **mkw))
        except (NotImplementedError, RuntimeError):
            return          # no meta kernel: nothing to learn here
        for t in outs:
            if _nbytes(t) > self.max_plain_bytes:
                raise MemoryError(
                    f"{func} would make a plain tensor of {_nbytes(t)} "
                    f"bytes {tuple(t.shape)}: the step must make it like "
                    f"a sharded input")

    def _record(self, func, args, kwargs, ins, outs, out) -> None:

        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns in _COLL_NAMESPACES:
            if name in _WAITS:
                return
            if name in _COLLECTIVES:
                kind = _COLLECTIVES[name]
                res = sum(map(_nbytes, outs))
                if kind == "all-gather" and _in_cpu_alltoall():
                    kind, res = "all-to-all", sum(map(_nbytes, ins))
                self.stats[f"coll:{kind}"] += res
                self.stats["traffic_bytes"] += res + sum(map(_nbytes, ins))
                for t in outs:
                    self._track(t)
                return
        in_keys = {_storage_key(t) for t in ins}
        mutates = func._schema.is_mutable
        new = [t for t in outs if _storage_key(t) not in in_keys]
        if not new and not mutates:
            return                                  # a view
        for t in new:
            self._track(t)
        traffic = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        self.stats["traffic_bytes"] += traffic
        if (self.trip_count and not any(isinstance(t, FakeTensor)
                                        for t in (*ins, *outs))
                and _issued_by_dtensor()):
            # DTensor's own work on plain tensors (its sharding
            # propagation, cached once a layout is planned): not a loop
            # body's, so not counted again by trip count
            self._dtensor_traffic += traffic
        if func._overloadpacket in flop_registry:
            self.stats["dot_flops"] += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)

    # -- results ------------------------------------------------------------
    def result(self) -> Dict[str, float]:
        """:func:`parse_hlo_stats`'s dict: ``dot_flops``,
        ``traffic_bytes``, ``coll:<type>`` and ``collective_bytes``."""
        return parse_op_stats(self.stats)


def parse_op_stats(stats: Dict[str, float]) -> Dict[str, float]:
    """The recorded counts in the keys of the reference's
    ``parse_hlo_stats``."""
    out = {"dot_flops": float(stats.get("dot_flops", 0.0)),
           "traffic_bytes": float(stats.get("traffic_bytes", 0.0))}
    coll = 0.0
    for k, v in sorted(stats.items()):
        if k.startswith("coll:"):
            out[k] = float(v)
            coll += v
    out["collective_bytes"] = coll
    return out


def op_collectives(stats: Dict[str, float]) -> Dict[str, int]:
    """The reference's ``parse_hlo_collectives`` shape: bytes per
    collective type plus ``total``."""
    s = parse_op_stats(stats)
    out = {k[5:]: int(v) for k, v in s.items() if k.startswith("coll:")}
    out["total"] = int(s["collective_bytes"])
    return out
