"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Runs the :class:`~repro_torch.runtime.trainer.Trainer` (checkpoint /
restart, straggler tracking) with the smoke-scale config of an
architecture of the registry by default, or its full config with
``--full-config``, on ``--device`` (default: the card).  The flags and
defaults are those of the reference's ``repro.launch.train`` (whose
``--dry-run`` lowering for a mesh has no counterpart on one card), and so
is the output: the last three metric lines as JSON.  The weights and the
synthetic data come from torch generators, so the losses differ from the
reference launcher's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--full-config", action="store_true",
                    help="use the full arch config (default: smoke-scale)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--spls", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda'; pass "
                         "'cpu' to run on the CPU)")
    return ap


def train_config(arch: str, full_config: bool = False, spls: bool = False):
    """The launcher's model config: the registry's ``arch``, at its smoke
    form with remat off unless ``full_config``; with ``spls``, the
    reference launcher's SPLS knobs on attention archs."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    if not full_config:
        cfg = dataclasses.replace(cfg.smoke(), remat=False)
    if spls and cfg.has_attn:
        from repro_torch.core.spls import SPLSConfig
        cfg = dataclasses.replace(cfg, spls=SPLSConfig(
            enabled=True, k_ratio=0.2, s_threshold=0.6, f_threshold=2,
            window=4, causal=cfg.causal))
    return cfg


def main(argv=None) -> int:
    args = parser().parse_args(argv)

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.trainer import Trainer, TrainerConfig

    cfg = train_config(args.arch, args.full_config, args.spls)
    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch,
        input_mode=cfg.input_mode, d_model=cfg.d_model)
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, peak_lr=args.lr,
                         n_micro=args.n_micro)
    out = Trainer(cfg, tcfg, data_cfg, device=args.device).run()
    print(json.dumps(out["metrics"][-3:], indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
