"""The port's collective and sharded-state paths against the reference's on
the CPU, over real ``gloo`` process groups of spawned processes
(``tests/_dist_workers.py``):

* ``compressed_mean`` over 4 ranks, two steps with error feedback: held
  against the mean over ranks of the reference's ``compress`` /
  ``decompress`` and against the reference's ``compressed_mean`` under
  ``shard_map`` over 4 host devices (a subprocess: jax fixes its device
  count at its first import) -- rtol = atol = 1e-6 (a mean of four float32
  terms summed in another order); residuals exactly (each rank's own
  arithmetic);
* ``restore_checkpoint(..., shardings=)`` of a checkpoint the reference
  wrote, onto a 2 x 2 ``(data, model)`` mesh: each rank's local shard
  equals the matching slice of the array, exactly;
* the reference's ``test_reshard_roundtrip_across_meshes`` on a 1 x 1
  mesh, and ``Trainer(mesh=)`` on a 1 x 1 mesh against ``Trainer()``
  (equal parameters after a step), over the ``fake`` group in this
  process;
* ``Trainer(mesh=)`` started from the ``DTensor`` leaves of a sharded
  restore, on a 1 x 1 mesh over a one-rank ``gloo`` group in this
  process, against ``Trainer()`` from a plain restore (equal parameters
  and loss after a step).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.checkpoint import save_checkpoint as jax_save
from repro.optim import grad_compress as jgc
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.launch.mesh import make_cpu_mesh
from repro_torch.sharding import NamedSharding, PartitionSpec as P

import _dist_workers
from _torch_parity import fake_world

WORLD = 4
ROOT = Path(__file__).resolve().parents[1]


def _spawn(fn, tmp: Path, *args) -> list:
    """Run ``fn(rank, WORLD, store, *args, out_dir)`` on WORLD spawned
    ranks; the ranks' saved outputs, in rank order."""
    out = tmp / "out"
    out.mkdir()
    mp.start_processes(fn, args=(WORLD, str(tmp / "store")) + args
                       + (str(out),), nprocs=WORLD, join=True,
                       start_method="spawn")
    res = []
    for r in range(WORLD):
        with np.load(out / f"rank{r}.npz") as f:
            res.append(dict(f))
    return res


def _grads() -> dict:
    rng = np.random.default_rng(7)
    # 600 elements: two full blocks of 256 and a padded tail
    g0 = rng.normal(size=(WORLD, 20, 30)).astype(np.float32)
    g1 = (rng.normal(size=(WORLD, 20, 30)) * 1e-3).astype(np.float32)
    g0[1, 0, :5] = 40.0       # one rank's outliers set its block scale
    return {"g0": g0, "g1": g1}


def test_compressed_mean_over_gloo(tmp_path):
    arrays = _grads()
    np.savez(tmp_path / "g.npz", **arrays)
    ranks = _spawn(_dist_workers.compressed_mean_rank, tmp_path,
                   str(tmp_path / "g.npz"))

    # oracle 1: the mean of the reference's decompressed codes over ranks
    shape = arrays["g0"].shape[1:]
    res = [None] * WORLD
    for step in ("0", "1"):
        deq, new = [], []
        for r in range(WORLD):
            q, s, nr = jgc.compress(jnp.asarray(arrays["g" + step][r]),
                                    res[r])
            deq.append(np.asarray(jgc.decompress(q, s, shape)))
            new.append(nr)
        want = np.mean(np.stack(deq), 0)
        for r in range(WORLD):
            np.testing.assert_allclose(ranks[r]["m" + step], want,
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_array_equal(ranks[r]["r" + step],
                                          np.asarray(new[r]))
        res = new
    # every rank holds the same mean
    for r in range(1, WORLD):
        np.testing.assert_array_equal(ranks[r]["m1"], ranks[0]["m1"])

    # oracle 2: the reference's compressed_mean under shard_map
    np.savez(tmp_path / "in.npz", spec=np.asarray(json.dumps({})),
             **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={WORLD}",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                           str(ROOT / "tests")]))
    subprocess.run([sys.executable, str(ROOT / "tests" /
                                        "_ref_mesh_worker.py"),
                    "compressed_mean", str(tmp_path / "in.npz"),
                    str(tmp_path / "ref.npz")], env=env, check=True,
                   timeout=300)
    with np.load(tmp_path / "ref.npz") as f:
        ref = dict(f)
    for r in range(WORLD):
        for k in ("m0", "m1"):
            np.testing.assert_allclose(ranks[r][k], ref[k][r], rtol=1e-6,
                                       atol=1e-6)
        for k in ("r0", "r1"):
            np.testing.assert_array_equal(ranks[r][k], ref[k][r])


def test_compressed_mean_needs_a_process_group():
    from repro_torch.optim import compressed_mean
    with pytest.raises((RuntimeError, ValueError)):
        compressed_mean(torch.ones(8))


SPECS = {"w": ((8, 6), ("data", "model")),
         "b": ((6,), (None,)),
         "e": ((4, 8, 2), (("data", "model"), None, None)),
         "v": ((10, 4), (None, "model"))}


def test_sharded_restore_on_a_2x2_gloo_mesh(tmp_path):
    rng = np.random.default_rng(3)
    tree = {k: jnp.asarray(rng.normal(size=shape).astype(np.float32))
            for k, (shape, _) in SPECS.items()}
    jax_save(str(tmp_path / "ckpt"), 5, tree)
    ranks = _spawn(_dist_workers.sharded_restore_rank, tmp_path,
                   str(tmp_path / "ckpt"), SPECS)
    for r, got in enumerate(ranks):
        assert int(got["step"]) == 5
        d, m = (int(c) for c in got["coord"])
        full = {k: np.asarray(v) for k, v in tree.items()}
        want = {"w": full["w"][d * 4:(d + 1) * 4, m * 3:(m + 1) * 3],
                "b": full["b"],
                "e": full["e"][d * 2 + m],
                "v": full["v"][:, m * 2:(m + 1) * 2]}
        want["e"] = want["e"][None]
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=f"rank {r} {k}")
        assert "Shard(dim=0)" in str(got["w/placements"])


def test_reshard_roundtrip_across_meshes(tmp_path):
    """A checkpoint written under one sharding restores onto another mesh
    (the reference's ``TestElastic`` case, on a 1 x 1 mesh)."""
    x = torch.arange(64.0).reshape(8, 8)
    save_checkpoint(str(tmp_path), 1, {"x": x})
    with fake_world(1):
        mesh = make_cpu_mesh(1, 1)
        shd = {"x": NamedSharding(mesh, P("data", None))}
        got, _, _ = restore_checkpoint(str(tmp_path),
                                       {"x": torch.zeros_like(x)},
                                       device="cpu", shardings=shd)
        assert tuple(got["x"].shape) == (8, 8)
        np.testing.assert_array_equal(got["x"].to_local().numpy(),
                                      x.numpy())


def test_trainer_with_a_1x1_mesh_equals_trainer_without(tmp_path):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import train_config
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.tree import leaves

    cfg = train_config("qwen3-0.6b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                      global_batch=2)
    tcfg = TrainerConfig(total_steps=1, log_every=1)
    plain = Trainer(cfg, tcfg, data, device="cpu")
    out_plain = plain.run()
    with fake_world(1):
        meshed = Trainer(cfg, tcfg, data, device="cpu",
                         mesh=make_cpu_mesh(1, 1))
        out_mesh = meshed.run()
    assert out_mesh["final_step"] == out_plain["final_step"] == 1
    for a, b in zip(leaves(meshed.params), leaves(plain.params)):
        assert torch.equal(a, b)
    assert out_mesh["metrics"][0]["loss"] == out_plain["metrics"][0]["loss"]


def test_trainer_steps_from_a_sharded_restore(tmp_path):
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import train_config
    from repro_torch.runtime.trainer import Trainer, TrainerConfig
    from repro_torch.sharding.rules import (opt_state_sharding,
                                            param_sharding)
    from repro_torch.tree import leaves

    cfg = train_config("qwen3-0.6b")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                      global_batch=2)
    tcfg = TrainerConfig(total_steps=1, log_every=1)
    src = Trainer(cfg, tcfg, data, device="cpu")
    src.init_state()
    like = {"params": src.params, "opt": src.opt_state}
    save_checkpoint(str(tmp_path / "ckpt"), 0, like)

    plain_state, _, _ = restore_checkpoint(str(tmp_path / "ckpt"), like,
                                           device="cpu")
    plain = Trainer(cfg, tcfg, data, device="cpu")
    plain.params, plain.opt_state = plain_state["params"], plain_state["opt"]
    out_plain = plain.run()

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_cpu_mesh(1, 1)
        pshd = param_sharding(cfg, mesh, like["params"])
        shd = {"params": pshd, "opt": opt_state_sharding(pshd, like["opt"])}
        state, _, _ = restore_checkpoint(str(tmp_path / "ckpt"), like,
                                         device="cpu", shardings=shd)
        assert all(isinstance(x, DTensor) for x in leaves(state))
        meshed = Trainer(cfg, tcfg, data, device="cpu", mesh=mesh)
        meshed.params, meshed.opt_state = state["params"], state["opt"]
        out_mesh = meshed.run()
    finally:
        dist.destroy_process_group()
    assert out_mesh["final_step"] == out_plain["final_step"] == 1
    for a, b in zip(leaves(meshed.params), leaves(plain.params)):
        assert not isinstance(a, DTensor)
        assert torch.equal(a, b)
    assert out_mesh["metrics"][0]["loss"] == out_plain["metrics"][0]["loss"]
