"""Ablation: sweep the SPLS hyper-parameters (k, s) on a trained model and
print the accuracy against the dense model -- the offline analogue of the
paper's Figs 16 / 19 grid search (the reference's
``examples/spls_ablation.py`` on the port).

  PYTHONPATH=src python -m repro_torch.spls_ablation [--steps 200]
      [--device cpu]

A 2-layer model trains densely for ``--steps`` steps (the reference's 200)
on the synthetic ``lm`` task; each (k, s) of the grid then evaluates the
same weights with SPLS applied at inference, without fine-tuning.
``--device`` defaults to the card.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, BlockCfg
from repro_torch.core.spls import SPLSConfig
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.models import loss_fn
from repro_torch.runtime import Trainer, TrainerConfig

K_GRID = (0.3, 0.2, 0.12)
S_GRID = (0.4, 0.6, 0.8)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda'; pass "
                         "'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    base = ArchConfig(
        name="ablate", n_layers=2, d_model=64, n_heads=8, n_kv_heads=8,
        head_dim=8, d_ff=256, vocab_size=64, period=(BlockCfg(),),
        remat=False)
    data = DataConfig(vocab_size=64, seq_len=64, global_batch=8, seed=11)

    # train dense once
    t = Trainer(base, TrainerConfig(total_steps=args.steps, log_every=50,
                                    peak_lr=2e-3, warmup_steps=20), data,
                device=args.device)
    out = t.run()
    dense_acc = out["metrics"][-1]["accuracy"]
    eval_batch = synthetic_batch(data, 10_000, t.device)
    print(f"dense: train-acc {dense_acc:.3f}")
    print(f"{'config':28s} {'eval_acc':>8s} {'delta':>8s}")

    with torch.no_grad():
        _, dm = loss_fn(base, t.params, eval_batch)
        dense_eval = float(dm["accuracy"])
        print(f"{'dense':28s} {dense_eval:8.3f} {0.0:8.3f}")
        rows = {"dense": dense_eval}
        for k in K_GRID:
            for s in S_GRID:
                cfg = dataclasses.replace(base, spls=SPLSConfig(
                    enabled=True, k_ratio=k, s_threshold=s, f_threshold=4,
                    window=8, causal=True))
                _, m = loss_fn(cfg, t.params, eval_batch)
                acc = float(m["accuracy"])
                tag = f"spls k={k} s={s}"
                rows[tag] = acc
                print(f"{tag:28s} {acc:8.3f} {acc - dense_eval:8.3f}")
    print("(apply-at-inference without fine-tuning; the paper fine-tunes "
          "under sparsity, which recovers most of the gap)")
    return {"train_accuracy": dense_acc, "eval_accuracy": rows}


if __name__ == "__main__":
    main()
