"""The training loop: checkpoint/restart, failure healing and straggler
tracking -- the reference's ``repro.runtime.trainer`` on one device.

``device`` (default: the card) holds the state.  With a ``mesh``, every
step runs under ``axis_rules(activation_rules(mesh), mesh)``, as the
reference's does: the mesh's model axis picks the attention's head layout
(:func:`repro_torch.models.attention.head_shard_mode`), and the tensors
stay plain ones, one global view on every rank, so on a 1 x 1 mesh a step
equals the step without one.  State given as ``DTensor`` leaves, as
``restore_checkpoint(..., shardings=)`` restores it onto a mesh, is
gathered to full tensors on ``device`` when :meth:`Trainer.run` starts:
the step works on plain tensors.  A step's
time is the card's: the loop synchronizes the device before it reads the
clock at the end of a step, so ``step_time_s`` and the
:class:`~repro_torch.runtime.fault_tolerance.StragglerDetector` measure the
step's work, not only its launch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.checkpoint.ckpt import (latest_step, restore_checkpoint,
                                        save_checkpoint)
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.sharding.logical import axis_rules
from repro_torch.sharding.rules import activation_rules
from repro_torch.tree import tree_map

from .fault_tolerance import (FailureSimulator, Heartbeat, StragglerDetector,
                              retry_with_backoff)

__all__ = ["TrainerConfig", "Trainer", "train_loop"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    peak_lr: float = 3e-4
    warmup_steps: int = 20
    n_micro: int = 1
    seed: int = 0
    keep_checkpoints: int = 3
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


class Trainer:
    """Owns the (params, opt_state, step) triple and the healing loop."""

    def __init__(self, cfg, tcfg: TrainerConfig, data_cfg: DataConfig,
                 device: Optional[str] = None,
                 failure_sim: Optional[FailureSimulator] = None, mesh=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.data_cfg = data_cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.failure_sim = failure_sim
        self.heartbeat = Heartbeat(timeout_s=300.0)
        self.stragglers = StragglerDetector()
        self.metrics_log: list = []

        sched = warmup_cosine(tcfg.peak_lr, tcfg.warmup_steps,
                              tcfg.total_steps)
        self._train_step = make_train_step(cfg, tcfg.opt, sched,
                                           tcfg.n_micro)

        self.params = None
        self.opt_state = None
        self.step = 0

    # ------------------------------------------------------------------
    def init_state(self) -> None:
        self.params = init_params(self.cfg, seed=self.tcfg.seed,
                                  device=self.device)
        self.opt_state = adamw_init(self.tcfg.opt, self.params)
        self.step = 0

    def restore_or_init(self) -> None:
        d = self.tcfg.ckpt_dir
        if d and latest_step(d) is not None:
            self.init_state()  # structure template
            state = {"params": self.params, "opt": self.opt_state}
            state, step, _ = restore_checkpoint(d, state,
                                                device=self.device)
            self.params, self.opt_state = state["params"], state["opt"]
            self.step = step
        else:
            self.init_state()

    def save(self) -> None:
        if not self.tcfg.ckpt_dir:
            return
        retry_with_backoff(lambda: save_checkpoint(
            self.tcfg.ckpt_dir, self.step,
            {"params": self.params, "opt": self.opt_state},
            data_step=self.step, keep=self.tcfg.keep_checkpoints))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    def run(self, host: str = "host0") -> Dict[str, Any]:
        """Run to ``total_steps``, healing injected failures by restoring
        the last checkpoint."""
        if self.mesh is None:
            return self._run(host)
        with axis_rules(activation_rules(self.mesh), self.mesh):
            return self._run(host)

    def _run(self, host: str) -> Dict[str, Any]:
        if self.params is None:
            self.restore_or_init()
        self.params, self.opt_state = _gathered(
            (self.params, self.opt_state), self.device)
        while self.step < self.tcfg.total_steps:
            try:
                t0 = time.monotonic()
                if self.failure_sim is not None:
                    self.failure_sim.maybe_fail(self.step)
                batch = synthetic_batch(self.data_cfg, self.step,
                                        self.device)
                self.params, self.opt_state, metrics = self._train_step(
                    self.params, self.opt_state, batch)
                self._sync()
                dt = time.monotonic() - t0
                self.heartbeat.ping(host)
                self.stragglers.record(host, dt)
                self.step += 1
                if self.step % self.tcfg.log_every == 0 or \
                        self.step == self.tcfg.total_steps:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = self.step
                    m["step_time_s"] = dt
                    self.metrics_log.append(m)
                if self.tcfg.ckpt_dir and \
                        self.step % self.tcfg.ckpt_every == 0:
                    self.save()
            except Exception:  # noqa: BLE001 -- heal-or-die loop
                if self.tcfg.ckpt_dir and latest_step(
                        self.tcfg.ckpt_dir) is not None:
                    # node failure: restore the last committed state (a
                    # step may have failed half way through its in-place
                    # update)
                    self.params = None
                    self.restore_or_init()
                    continue
                raise
        self.save()
        return {"final_step": self.step, "metrics": self.metrics_log}


def _gathered(tree, device: torch.device):
    """``tree`` with each ``DTensor`` leaf replaced by its full tensor on
    ``device`` (an all-gather over the leaf's mesh); other leaves as they
    are."""
    from torch.distributed.tensor import DTensor

    return tree_map(lambda t: t.full_tensor().to(device)
                    if isinstance(t, DTensor) else t, tree)


def train_loop(cfg, tcfg: TrainerConfig, data_cfg: DataConfig,
               device: Optional[str] = None,
               failure_sim: Optional[FailureSimulator] = None
               ) -> Dict[str, Any]:
    return Trainer(cfg, tcfg, data_cfg, device, failure_sim).run()
