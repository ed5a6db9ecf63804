"""The port's training runtime on the CPU: the ports of the reference's
``TestTrainer`` (loss decreases, restart from a checkpoint, healing
injected failures, SPLS trains), ``TestFaultTolerance`` and
``TestElastic`` (all but the mesh round-trip, which waits for the
mesh-bound layers), a restored run that continues as the uninterrupted
one did, the training launcher on every architecture of the registry and
a short ``train_lm``.

Tolerances: a run restored from its step-2 checkpoint reproduces the
uninterrupted run's losses and parameters exactly on the CPU (the same
ops on the same restored bits).
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math

import pytest
import torch

from repro_torch.configs.base import ArchConfig, BlockCfg
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.launch import train as launch_train
from repro_torch.runtime import (FailureSimulator, Heartbeat,
                                 StragglerDetector, Trainer, TrainerConfig,
                                 plan_elastic_mesh, rescale_batch)
from repro_torch.runtime.fault_tolerance import retry_with_backoff
from repro_torch.tree import leaves


def _tiny_cfg(**kw):
    base = dict(name="tiny", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                head_dim=16, d_ff=64, vocab_size=64,
                period=(BlockCfg(),), remat=False)
    base.update(kw)
    return ArchConfig(**base)


def _tiny_data(cfg):
    return DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)


class TestTrainer:
    def test_loss_decreases(self):
        cfg = _tiny_cfg()
        t = Trainer(cfg, TrainerConfig(total_steps=60, log_every=10),
                    _tiny_data(cfg), device="cpu")
        out = t.run()
        losses = [m["loss"] for m in out["metrics"]]
        assert out["final_step"] == 60
        assert losses[-1] < losses[0] - 0.3, losses

    def test_restart_resumes_from_checkpoint(self, tmp_path):
        cfg = _tiny_cfg()
        tc = TrainerConfig(total_steps=30, ckpt_dir=str(tmp_path),
                           ckpt_every=10, log_every=5)
        t1 = Trainer(cfg, tc, _tiny_data(cfg), device="cpu")
        t1.restore_or_init()
        while t1.step < 20:
            b = synthetic_batch(t1.data_cfg, t1.step, device="cpu")
            t1.params, t1.opt_state, _ = t1._train_step(
                t1.params, t1.opt_state, b)
            t1.step += 1
            if t1.step % 10 == 0:
                t1.save()
        t2 = Trainer(cfg, tc, _tiny_data(cfg), device="cpu")
        t2.restore_or_init()
        assert t2.step == 20

    def test_heals_injected_failures(self, tmp_path):
        cfg = _tiny_cfg()
        sim = FailureSimulator(fail_at_steps=(12, 23))
        t = Trainer(cfg, TrainerConfig(total_steps=30,
                                       ckpt_dir=str(tmp_path),
                                       ckpt_every=5, log_every=10),
                    _tiny_data(cfg), device="cpu", failure_sim=sim)
        out = t.run()
        assert out["final_step"] == 30  # survived two failures
        assert sim._fired == {12, 23}

    def test_spls_trains(self):
        from repro_torch.core.spls import SPLSConfig
        cfg = _tiny_cfg(spls=SPLSConfig(enabled=True, k_ratio=0.3,
                                        s_threshold=0.6, f_threshold=1,
                                        window=4))
        t = Trainer(cfg, TrainerConfig(total_steps=30, log_every=10),
                    _tiny_data(cfg), device="cpu")
        out = t.run()
        assert math.isfinite(out["metrics"][-1]["loss"])


def test_restored_run_continues_the_uninterrupted_one(tmp_path):
    """A fresh Trainer restored from step 2 runs steps 3-4 as the
    uninterrupted run did: the same losses and parameters, exactly, with
    remat on and two microbatches."""
    cfg = _tiny_cfg(remat=True)
    tc = dict(total_steps=4, ckpt_every=2, log_every=1, n_micro=2,
              warmup_steps=1)
    a = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "a"), **tc),
                _tiny_data(cfg), device="cpu")
    out_a = a.run()
    import shutil
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_000000002",
                    tmp_path / "b" / "step_000000002")
    b = Trainer(cfg, TrainerConfig(ckpt_dir=str(tmp_path / "b"), **tc),
                _tiny_data(cfg), device="cpu")
    b.restore_or_init()
    assert b.step == 2 and int(b.opt_state.count) == 2
    out_b = b.run()
    assert [m["loss"] for m in out_b["metrics"]] == \
        [m["loss"] for m in out_a["metrics"][2:]]
    for x, y in zip(leaves(a.params), leaves(b.params)):
        assert torch.equal(x, y)
    assert all(m["step_time_s"] > 0 for m in out_a["metrics"])


class TestFaultTolerance:
    def test_heartbeat(self):
        now = [0.0]
        hb = Heartbeat(timeout_s=10.0, clock=lambda: now[0])
        hb.ping("a")
        hb.ping("b")
        now[0] = 5.0
        hb.ping("a")
        now[0] = 12.0
        assert hb.dead_hosts() == ["b"]
        assert hb.alive_hosts() == ["a"]

    def test_straggler_detection(self):
        sd = StragglerDetector(threshold=2.0)
        for host in ("a", "b", "c"):
            for _ in range(8):
                sd.record(host, 1.0)
        sd.record("c", 5.0)
        assert sd.stragglers() == ["c"]

    def test_retry_with_backoff(self):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "ok"

        assert retry_with_backoff(flaky, max_retries=5,
                                  sleep=lambda s: None) == "ok"
        assert len(calls) == 3

    def test_retry_exhausts(self):
        with pytest.raises(OSError):
            retry_with_backoff(lambda: (_ for _ in ()).throw(OSError("x")),
                               max_retries=2, sleep=lambda s: None)


class TestElastic:
    def test_plan_survives_node_loss(self):
        plan = plan_elastic_mesh(alive=[f"h{i}" for i in range(60)],
                                 chips_per_host=4, model_parallel=16)
        assert plan.model == 16
        assert plan.data == 8  # 240 chips -> 15 data -> pow2 8

    def test_plan_raises_when_too_small(self):
        with pytest.raises(RuntimeError):
            plan_elastic_mesh(alive=["h0"], chips_per_host=4,
                              model_parallel=16)

    def test_rescale_policies(self):
        assert rescale_batch(256, 16, 8, "keep_global") == 256
        assert rescale_batch(256, 16, 8, "keep_per_shard") == 128


def _launch(*args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = launch_train.main(list(args) + ["--device", "cpu"])
    return rc, json.loads(buf.getvalue())


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_launch_train_every_arch(arch_id):
    """``launch.train`` at each smoke form, 2 steps: exit 0, finite
    losses, the reference launcher's output (the last metric lines)."""
    rc, out = _launch("--arch", arch_id, "--steps", "2", "--global-batch",
                      "2", "--seq-len", "16")
    assert rc == 0 and out and all(math.isfinite(m["loss"]) for m in out)
    assert out[-1]["step"] == 2


def test_launch_train_spls_checkpoints_micro(tmp_path):
    rc, out = _launch("--arch", "qwen3-0.6b", "--steps", "4", "--spls",
                      "--n-micro", "2", "--global-batch", "4", "--seq-len",
                      "32", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2")
    assert rc == 0 and math.isfinite(out[-1]["loss"])
    from repro_torch.checkpoint import latest_step
    assert latest_step(str(tmp_path)) == 4
    cfg = launch_train.train_config("qwen3-0.6b", spls=True)
    assert cfg.spls.enabled and cfg.spls.k_ratio == 0.2 and not cfg.remat


def test_train_lm_heals_its_failure(monkeypatch, capsys):
    """``train_lm``'s flow -- 2 microbatches, a failure injected at half
    of the steps and healed from the last checkpoint -- on the tiny config
    (the ~100M model is a run for the card)."""
    from repro_torch import train_lm
    assert abs(train_lm.build_cfg(False).param_count() - 100e6) < 30e6
    full = train_lm.build_cfg
    monkeypatch.setattr(train_lm, "build_cfg", lambda spls: (
        dataclasses.replace(_tiny_cfg(), spls=full(spls).spls)))
    out = train_lm.main(["--steps", "6", "--ckpt-every", "2",
                         "--log-every", "2", "--seq-len", "16", "--batch",
                         "4", "--device", "cpu"])
    assert out["final_step"] == 6
    assert "healed" in capsys.readouterr().out
