"""Checkpointing with a manifest and an atomic commit, in the layout of
the reference's ``repro.checkpoint.ckpt``, so a checkpoint written by one
package restores in the other::

    step_000000123/
      MANIFEST.json     # step, data step, each leaf's id, shape and dtype
      arrays/<leaf-id>.npy
      COMMITTED         # written last -- a dir without it is garbage

written under ``.tmp_step_*`` and renamed into place.  Leaf ids are the
trees' paths (:func:`repro_torch.tree.leaf_id`: ``params.periods.0.attn.wq``,
``opt.mu.embed``, ``opt.count``).

bfloat16 needs no ``ml_dtypes``: the reference's ``np.save`` of a
bfloat16 array writes raw 2-byte records (descr ``'<V2'``) with
``"bfloat16"`` in the manifest; the port writes the same file from the
tensor's bits (viewed as int16) and reads the records back the same way.
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import (leaf_id, leaves_with_path, tree_map,
                              tree_map_with_path)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "cleanup_old"]

def _save_leaf(path: Path, t: torch.Tensor) -> Tuple[list, str]:
    """Write one leaf as ``.npy``; returns its shape and manifest dtype.
    A bf16 leaf is written as the reference's ``np.save`` of an
    ``ml_dtypes.bfloat16`` array writes it: a header with descr ``'<V2'``,
    then the raw 2-byte records."""
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        arr = t.numpy()
        np.save(path, arr)
        return list(arr.shape), str(arr.dtype)
    bits = t.view(torch.int16).numpy()
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": bits.shape})
        f.write(bits.tobytes())
    return list(bits.shape), "bfloat16"


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.array(arr, copy=True, order="C")   # keeps a 0-d shape
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(base: str, step: int, tree: Any,
                    data_step: Optional[int] = None, keep: int = 3) -> str:
    """Write ``tree`` atomically under ``base/step_{step:09d}``; keep the
    newest ``keep`` committed checkpoints."""
    base_p = Path(base)
    final = base_p / f"step_{step:09d}"
    tmp = base_p / f".tmp_step_{step:09d}_{int(time.time() * 1e6)}"
    (tmp / "arrays").mkdir(parents=True, exist_ok=True)

    manifest = {"step": step, "data_step": data_step, "leaves": []}
    for path, leaf in leaves_with_path(tree):
        lid = leaf_id(path)
        shape, dtype_name = _save_leaf(tmp / "arrays" / f"{lid}.npy", leaf)
        manifest["leaves"].append(
            {"id": lid, "shape": shape, "dtype": dtype_name})
    (tmp / "MANIFEST.json").write_text(json.dumps(manifest, indent=1))
    (tmp / "COMMITTED").write_text(str(time.time()))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    cleanup_old(base, keep)
    return str(final)


def latest_step(base: str) -> Optional[int]:
    """Newest *committed* checkpoint step, or None."""
    base_p = Path(base)
    if not base_p.exists():
        return None
    steps = [int(d.name[5:]) for d in base_p.iterdir()
             if d.name.startswith("step_") and (d / "COMMITTED").exists()]
    return max(steps) if steps else None


def restore_checkpoint(base: str, tree_like: Any, step: Optional[int] = None,
                       device: Optional[str] = None, shardings: Any = None
                       ) -> Tuple[Any, int, Optional[int]]:
    """Restore into the structure of ``tree_like`` (each leaf cast to the
    like leaf's dtype) on ``device`` (default: the card).  Returns ``(tree,
    step, data_step)``; ``step`` defaults to the newest committed one.

    With ``shardings`` (a tree like ``tree_like`` of
    :class:`~repro_torch.sharding.NamedSharding`, e.g. from
    :func:`~repro_torch.sharding.rules.param_sharding`) each leaf becomes a
    ``DTensor`` on its mesh (on the mesh's device type) with its spec's
    placements: every rank reads the whole array and keeps its own shard,
    with no communication.  This is the elastic restart: the manifest
    knows no mesh, so the mesh may differ from the writer's."""
    if step is None:
        step = latest_step(base)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {base}")
    dev = resolve_device(device)
    d = Path(base) / f"step_{step:09d}"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    dtypes = {leaf["id"]: leaf["dtype"] for leaf in manifest["leaves"]}

    def load(path, like):
        lid = leaf_id(path)
        arr = np.load(d / "arrays" / f"{lid}.npy")
        t = _from_numpy(arr, dtypes.get(lid, str(arr.dtype)))
        return t.to(device=dev, dtype=like.dtype)

    tree = tree_map_with_path(load, tree_like)
    if shardings is not None:
        from torch.distributed.tensor import distribute_tensor

        tree = tree_map(lambda t, s: distribute_tensor(
            t.to(s.mesh.device_type), s.mesh, s.placements,
            src_data_rank=None), tree, shardings)
    return tree, manifest["step"], manifest.get("data_step")


def cleanup_old(base: str, keep: int) -> None:
    base_p = Path(base)
    if not base_p.exists():
        return
    steps = sorted(
        int(d.name[5:]) for d in base_p.iterdir()
        if d.name.startswith("step_") and (d / "COMMITTED").exists())
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(base_p / f"step_{s:09d}", ignore_errors=True)
    # remove stale tmp dirs (crashed writes)
    for d in base_p.iterdir():
        if d.name.startswith(".tmp_step_"):
            shutil.rmtree(d, ignore_errors=True)
