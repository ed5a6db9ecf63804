"""Abstract step inputs for every (architecture x input shape x step kind)
cell -- meta tensors paired with their shardings, no storage (the
reference's ``repro.launch.specs``, whose ``ShapeDtypeStruct`` carries its
sharding).

``train`` cells feed the training step; ``prefill`` cells the prefill
step (where SPLS runs); ``decode`` cells the serving step: one new token
against a KV cache of ``seq_len``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.models.common import dtype_of
from repro_torch.models.model import abstract_cache, abstract_params
from repro_torch.sharding.logical import NamedSharding
from repro_torch.sharding.rules import (batch_sharding, cache_sharding,
                                        param_sharding)
from repro_torch.tree import tree_map

__all__ = ["ShardedMeta", "input_specs", "abstract_params_sharded",
           "abstract_cache_sharded"]


@dataclasses.dataclass(frozen=True)
class ShardedMeta:
    """A meta tensor (shape and dtype) and the sharding it is laid out
    with."""

    tensor: torch.Tensor
    sharding: NamedSharding

    @property
    def placements(self) -> tuple:
        return self.sharding.placements


def _meta(shape, dtype, sharding) -> ShardedMeta:
    return ShardedMeta(torch.empty(shape, dtype=dtype, device="meta"),
                       sharding)


def abstract_params_sharded(cfg, mesh):
    """``(tree of ShardedMeta, tree of NamedSharding)`` of the parameters."""
    ab = abstract_params(cfg)
    shd = param_sharding(cfg, mesh, ab)
    return tree_map(ShardedMeta, ab, shd), shd


def abstract_cache_sharded(cfg, mesh, batch: int, max_len: int):
    """``(tree of ShardedMeta, tree of NamedSharding)`` of the decode
    cache."""
    ab = abstract_cache(cfg, batch, max_len)
    shd = cache_sharding(cfg, mesh, ab, batch, max_len)
    return tree_map(ShardedMeta, ab, shd), shd


def input_specs(cfg, shape, mesh) -> Dict[str, Any]:
    """Abstract step inputs of one cell: a dict with ``"kind"`` and

      train:   params, param_sharding, batch {inputs, labels}
      prefill: params, param_sharding, inputs
      decode:  params, param_sharding, cache, cache_sharding, tokens, pos
    """
    B, L = shape.global_batch, shape.seq_len
    bsh = batch_sharding(mesh, B)
    cdt = dtype_of(cfg.compute_dtype)
    params, pshard = abstract_params_sharded(cfg, mesh)

    def inputs(n_tok: int) -> ShardedMeta:
        if cfg.input_mode == "tokens":
            return _meta((B, n_tok), torch.int32, bsh)
        return _meta((B, n_tok, cfg.d_model), cdt, bsh)

    if shape.kind == "train":
        return {"kind": "train", "params": params, "param_sharding": pshard,
                "batch": {"inputs": inputs(L),
                          "labels": _meta((B, L), torch.int32, bsh)}}
    if shape.kind == "prefill":
        return {"kind": "prefill", "params": params,
                "param_sharding": pshard, "inputs": inputs(L)}
    # decode: one new token, the cache holds seq_len positions
    cache, cshard = abstract_cache_sharded(cfg, mesh, B, L)
    return {"kind": "decode", "params": params, "param_sharding": pshard,
            "cache": cache, "cache_sharding": cshard, "tokens": inputs(1),
            "pos": _meta((B,), torch.int32, bsh)}
