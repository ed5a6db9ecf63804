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
own index arithmetic and are not counted.
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
    production shape allocates host memory that a device would hold."""

    def __init__(self, fake_mode=None, max_plain_bytes=None):
        super().__init__()
        self.fake_mode = fake_mode
        self.max_plain_bytes = max_plain_bytes
        self.stats: Dict[str, float] = defaultdict(float)
        self.live_bytes = 0
        self.peak_bytes = 0
        self._known = weakref.WeakValueDictionary()
        self.read = set()        # storages an op has read

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
        ``max_plain_bytes`` (its output shapes from a run on ``meta``)."""
        if any(isinstance(t, FakeTensor) for t in ins):
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
        self.stats["traffic_bytes"] += (sum(map(_nbytes, ins))
                                        + sum(map(_nbytes, outs)))
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
