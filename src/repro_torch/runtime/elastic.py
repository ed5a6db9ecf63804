"""Elastic scaling: re-mesh on node loss/gain and re-shard the state (a
copy of the reference's ``repro.runtime.elastic``; pure Python).

The protocol at cluster scale:
  1. Heartbeat declares hosts dead -> the coordinator computes the largest
     usable mesh from surviving hosts (:func:`plan_elastic_mesh`);
  2. every survivor restores the last committed checkpoint onto the *new*
     mesh -- the manifest is mesh-agnostic, so only the placement of the
     restored leaves differs: ``restore_checkpoint(..., shardings=
     param_sharding(cfg, new_mesh, abstract_params(cfg)))`` gives each
     leaf as a ``DTensor`` on the new mesh, and ``Trainer(...,
     mesh=new_mesh)`` trains on from that state (it gathers the leaves to
     full tensors when it starts: the port's step runs on plain tensors);
  3. the data pipeline resumes from the stored data step, with the global
     batch kept constant (per-host batch grows) or rescaled by policy.

Single-process, steps 1 and 3 are host-count arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

__all__ = ["ElasticPlan", "plan_elastic_mesh", "rescale_batch"]


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    dropped_hosts: Tuple[str, ...]
    note: str


def _largest_pow2_leq(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


def plan_elastic_mesh(alive: List[str], chips_per_host: int,
                      model_parallel: int,
                      prev_data: Optional[int] = None) -> ElasticPlan:
    """Largest (data, model) mesh from surviving hosts.

    Model parallelism is fixed (it is baked into layer shardings and wants
    full ICI rings); the data axis absorbs the loss, rounded down to a
    power of two so microbatching stays divisible.
    """
    chips = len(alive) * chips_per_host
    if chips < model_parallel:
        raise RuntimeError(
            f"only {chips} chips alive; cannot sustain model={model_parallel}")
    data = _largest_pow2_leq(chips // model_parallel)
    note = "full" if prev_data in (None, data) else (
        f"degraded data {prev_data} -> {data}")
    return ElasticPlan(data=data, model=model_parallel, dropped_hosts=(),
                       note=note)


def rescale_batch(global_batch: int, old_data: int, new_data: int,
                  policy: str = "keep_global") -> int:
    """Batch policy after a re-mesh.

    keep_global: per-shard batch grows (gradient math unchanged).
    keep_per_shard: global batch shrinks proportionally (throughput-true,
    requires an LR rescale by the caller).
    """
    if policy == "keep_global":
        if global_batch % new_data:
            raise ValueError(
                f"global batch {global_batch} not divisible by data={new_data}")
        return global_batch
    if policy == "keep_per_shard":
        return global_batch * new_data // old_data
    raise ValueError(policy)
