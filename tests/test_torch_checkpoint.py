"""The port's checkpoints against the reference's layout: a checkpoint
written by either package restores in the other (float32 and int32 leaves,
a parameter tree of dicts and tuples and an AdamW state), bf16 leaves
written as the reference writes them (raw 2-byte records, ``"bfloat16"``
in the manifest), and the port of the reference's ``TestCheckpoint``.
Restored values are equal exactly.

The reference cannot restore a bf16 leaf, not even its own: ``np.load``
gives raw ``|V2`` records, which ``astype(bfloat16)`` refuses ("No cast
function available").  So the reverse direction for bf16 is held at the
files: the port writes byte for byte the files the reference writes.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro.optim import AdamWConfig as JAdamW
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import (cleanup_old, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.tree import leaf_id, leaves_with_path, tree_map
from repro_torch.weights import opt_state_from_jax, params_from_jax

from _torch_parity import n

jax.config.update("jax_platform_name", "cpu")


def _jtree(dtype=jnp.float32):
    r = np.random.default_rng(0)
    params = {"embed": jnp.asarray(r.standard_normal((6, 4)), dtype),
              "periods": ({"attn": {"wq": jnp.asarray(
                  r.standard_normal((2, 4, 1, 2, 3)), dtype)},
                  "ln1": jnp.zeros((2, 4), dtype)},),
              "final_norm": jnp.asarray(r.standard_normal(4), dtype)}
    return {"params": params, "opt": jadamw_init(JAdamW(), params)}


def _port(jtree):
    np_tree = jax.tree.map(np.asarray, jtree)
    return {"params": params_from_jax(np_tree["params"], device="cpu"),
            "opt": opt_state_from_jax(np_tree["opt"], device="cpu")}


def _equal(got, want):
    got = {leaf_id(p): v for p, v in leaves_with_path(got)}
    want = {leaf_id(p): v for p, v in leaves_with_path(want)}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


def test_leaf_ids_match_reference(tmp_path):
    jt = _jtree()
    save_checkpoint(str(tmp_path / "t"), 3, _port(jt), data_step=3)
    jck.save_checkpoint(str(tmp_path / "j"), 3, jt, data_step=3)
    mt, mj = (json.loads((tmp_path / d / "step_000000003" / "MANIFEST.json")
                         .read_text()) for d in ("t", "j"))
    assert mt == mj
    assert {"params.periods.0.attn.wq", "opt.mu.embed", "opt.count"} <= {
        leaf["id"] for leaf in mt["leaves"]}


def test_reference_checkpoint_restores_in_port(tmp_path):
    for dtype in (jnp.float32, jnp.bfloat16):
        d = str(tmp_path / str(dtype.dtype))
        jt = _jtree(dtype)
        jck.save_checkpoint(d, 12, jt, data_step=12)
        like = tree_map(torch.zeros_like, _port(jt))
        got, step, data_step = restore_checkpoint(d, like, device="cpu")
        assert (step, data_step) == (12, 12)
        _equal(got, _port(jt))


def test_port_checkpoint_restores_in_reference(tmp_path):
    jt = _jtree()
    save_checkpoint(str(tmp_path), 5, _port(jt), data_step=4)
    got, step, data_step = jck.restore_checkpoint(
        str(tmp_path), jax.tree.map(jnp.zeros_like, jt))
    assert (step, data_step) == (5, 4)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(
        np.asarray(a), np.asarray(b)), got, jt)


def test_bf16_files_equal_the_reference(tmp_path):
    jt = _jtree(jnp.bfloat16)
    save_checkpoint(str(tmp_path / "t"), 1, _port(jt))
    jck.save_checkpoint(str(tmp_path / "j"), 1, jt)
    arrays = tmp_path / "j" / "step_000000001" / "arrays"
    for f in sorted(arrays.iterdir()):
        mine = tmp_path / "t" / "step_000000001" / "arrays" / f.name
        assert mine.read_bytes() == f.read_bytes(), f.name
    with pytest.raises(ValueError, match="No cast function"):
        jck.restore_checkpoint(str(tmp_path / "t"), jt)


def test_restore_onto_other_dtype_and_device_default(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"x": torch.ones(3)})
    got, _, _ = restore_checkpoint(str(tmp_path),
                                   {"x": torch.zeros(3, dtype=torch.bfloat16)},
                                   device="cpu")
    assert got["x"].dtype == torch.bfloat16
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            restore_checkpoint(str(tmp_path), {"x": torch.zeros(3)})


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(12.).reshape(3, 4),
                "b": (torch.ones(2), {"c": torch.zeros(5, dtype=torch.int32)})}
        save_checkpoint(str(tmp_path), 7, tree, data_step=7)
        got, step, dstep = restore_checkpoint(
            str(tmp_path), tree_map(torch.zeros_like, tree), device="cpu")
        assert step == 7 and dstep == 7
        _equal(got, tree)

    def test_latest_and_cleanup(self, tmp_path):
        for s in (10, 20, 30, 40):
            save_checkpoint(str(tmp_path), s, {"x": torch.ones(3)}, keep=2)
        assert latest_step(str(tmp_path)) == 40
        steps = sorted(int(d.name[5:]) for d in tmp_path.iterdir()
                       if d.name.startswith("step_"))
        assert steps == [30, 40]
        cleanup_old(str(tmp_path), 1)
        assert latest_step(str(tmp_path)) == 40

    def test_uncommitted_ignored(self, tmp_path):
        save_checkpoint(str(tmp_path), 5, {"x": torch.ones(3)})
        d = tmp_path / "step_000000099"
        (d / "arrays").mkdir(parents=True)
        (d / "MANIFEST.json").write_text("{}")
        assert latest_step(str(tmp_path)) == 5

    def test_restore_casts_dtype(self, tmp_path):
        save_checkpoint(str(tmp_path), 1, {"x": torch.ones(3)})
        got, _, _ = restore_checkpoint(
            str(tmp_path), {"x": torch.zeros(3, dtype=torch.bfloat16)},
            device="cpu")
        assert got["x"].dtype == torch.bfloat16
        assert n(got["x"].float()).tolist() == [1.0, 1.0, 1.0]
