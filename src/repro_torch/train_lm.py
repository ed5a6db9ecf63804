"""End-to-end example: train a ~100M-parameter causal LM on the synthetic
pipeline with checkpointing and an injected node failure that the trainer
heals from (the reference's ``examples/train_lm.py`` on the port).

  PYTHONPATH=src python -m repro_torch.train_lm [--steps 300] [--spls]
      [--device cpu]

The model is 8 layers x d_model 768 (GQA 12 / 4) x d_ff 2304, vocab
32000; 2 microbatches a step; one failure is injected at half of the
steps and healed from the last checkpoint.  The reference's flags, plus
``--ckpt-every`` / ``--log-every`` (its 50 / 25) for short runs and
``--device`` (default: the card).  With 2 microbatches the step reports
no accuracy (the reference's ``make_loss_grad`` returns the loss alone),
so the summary line prints the loss.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from repro_torch.configs.base import ArchConfig, BlockCfg
from repro_torch.core.spls import SPLSConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.runtime import FailureSimulator, Trainer, TrainerConfig


def build_cfg(spls: bool) -> ArchConfig:
    """~100M params: 8 layers x d_model 768 (GQA 12/4) x d_ff 2304."""
    return ArchConfig(
        name="lm-100m", n_layers=8, d_model=768, n_heads=12, n_kv_heads=4,
        head_dim=64, d_ff=2304, vocab_size=32000,
        period=(BlockCfg(mixer="attn"),), remat=False,
        spls=SPLSConfig(enabled=spls, k_ratio=0.2, s_threshold=0.5,
                        f_threshold=4, window=8, causal=True))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--spls", action="store_true")
    ap.add_argument("--inject-failure", action="store_true", default=True)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda'; pass "
                         "'cpu' to run on the CPU)")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    cfg = build_cfg(args.spls)
    print(f"model: {cfg.name}  params={cfg.param_count() / 1e6:.1f}M  "
          f"spls={args.spls}")
    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                      global_batch=args.batch, seed=0)
    with tempfile.TemporaryDirectory() as ckdir:
        sim = (FailureSimulator(fail_at_steps=(args.steps // 2,))
               if args.inject_failure else None)
        t = Trainer(cfg, TrainerConfig(
            total_steps=args.steps, ckpt_dir=ckdir,
            ckpt_every=args.ckpt_every, log_every=args.log_every,
            peak_lr=3e-4, warmup_steps=50, n_micro=2),
            data, device=args.device, failure_sim=sim)
        out = t.run()
    print(json.dumps(out["metrics"], indent=1))
    first, last = out["metrics"][0], out["metrics"][-1]
    print(f"loss {first['loss']:.3f} -> {last['loss']:.3f}")
    if args.inject_failure:
        print("(one node failure was injected mid-run and healed from the "
              "last checkpoint)")
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
