"""Rank functions of the port's multi-process tests
(``tests/test_torch_dist.py``), spawned with ``torch.multiprocessing``:
each joins a ``gloo`` group through a file store, runs its part, writes
what it got to ``out_dir/rank<r>.npz`` and leaves the group.  They import
torch and the port only."""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _join(rank: int, world: int, store: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)


def compressed_mean_rank(rank: int, world: int, store: str, src: str,
                         out_dir: str) -> None:
    """Two steps of ``compressed_mean`` with error feedback on this rank's
    gradients ``g0[rank]``, ``g1[rank]``."""
    from repro_torch.optim.grad_compress import compressed_mean

    _join(rank, world, store)
    try:
        with np.load(src) as f:
            g0, g1 = (torch.from_numpy(f[k][rank]) for k in ("g0", "g1"))
        m0, r0 = compressed_mean(g0)
        m1, r1 = compressed_mean(g1, residual=r0)
        np.savez(f"{out_dir}/rank{rank}.npz", m0=m0.numpy(), r0=r0.numpy(),
                 m1=m1.numpy(), r1=r1.numpy())
    finally:
        dist.destroy_process_group()


def sharded_restore_rank(rank: int, world: int, store: str, ckpt: str,
                         specs: dict, out_dir: str) -> None:
    """Restore ``ckpt`` onto a (2, 2) ``(data, model)`` mesh with the
    given specs; save each leaf's local shard and its placements."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch.mesh import make_cpu_mesh
    from repro_torch.sharding import NamedSharding, PartitionSpec

    _join(rank, world, store)
    try:
        mesh = make_cpu_mesh(2, 2)
        like = {k: torch.zeros(shape) for k, (shape, _) in specs.items()}
        shd = {k: NamedSharding(mesh, PartitionSpec(*spec))
               for k, (_, spec) in specs.items()}
        got, step, _ = restore_checkpoint(ckpt, like, device="cpu",
                                          shardings=shd)
        out = {"step": np.asarray(step),
               "coord": np.asarray(mesh.get_coordinate())}
        for k, v in got.items():
            out[k] = v.to_local().numpy()
            out[f"{k}/placements"] = np.asarray(repr(tuple(v.placements)))
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()
