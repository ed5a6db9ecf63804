"""Deterministic, restart-safe synthetic data pipeline: the reference's
``repro.data.pipeline`` with torch generators.

Batch ``step`` is a pure function of ``(cfg.seed, step)``, so a restarted
job resumes mid-epoch from the step stored in its checkpoint.  Two task
families: ``lm`` (a Markov successor stream from a table drawn from the
seed, with 10 % noise, so accuracy is learnable) and ``copy`` (pattern,
separator 1, pattern; the loss mask covers the second half).

The reference draws with ``jax.random``, which torch cannot reproduce, so
the batches' values differ from the reference's; the recursion that turns
draws into tokens is :func:`lm_tokens`, a pure function of the draws, so
tests feed it the reference's own draws.  Draws come from CPU generators
(the same batch on every device) and the batch is moved to ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["DataConfig", "synthetic_batch", "data_iterator", "lm_tokens"]

# stream tags of the generators: the lm table, a batch, the embeddings
_TABLE, _BATCH, _EMBED = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 256
    seq_len: int = 128
    global_batch: int = 8
    task: str = "lm"            # "lm" | "copy"
    seed: int = 0
    input_mode: str = "tokens"  # "tokens" | "embeddings"
    d_model: int = 0            # for embeddings mode
    ngram: int = 3              # structure order for the lm task


def _gen(*words: int) -> torch.Generator:
    """A CPU generator seeded from ``words`` (non-negative ints)."""
    state = np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) >> 1)


def lm_tokens(table: torch.Tensor, x0: torch.Tensor, noise: torch.Tensor,
              rand: torch.Tensor) -> torch.Tensor:
    """The ``lm`` stream from its draws: ``table (V,)`` successor table,
    ``x0 (B, ngram)`` start tokens, ``noise (B, L)`` bool, ``rand (B, L)``
    noise tokens -> tokens (B, L).  Token ``i`` is ``rand[:, i]`` where
    ``noise[:, i]``, else ``table[previous token] % V``; the token before
    the first is ``x0[:, -1]``."""
    V = table.shape[0]
    B, L = rand.shape
    out = torch.empty((B, L), dtype=rand.dtype, device=rand.device)
    prev = x0[:, -1]
    for i in range(L):
        prev = torch.where(noise[:, i], rand[:, i], table[prev.long()] % V)
        out[:, i] = prev
    return out


def _lm_draws(cfg: DataConfig, gen: torch.Generator):
    B, L, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    table = torch.randint(0, V, (V,), generator=_gen(cfg.seed, _TABLE),
                          dtype=torch.int32)
    x0 = torch.randint(0, V, (B, cfg.ngram), generator=gen,
                       dtype=torch.int32)
    noise = torch.rand((B, L), generator=gen) < 0.1
    rand = torch.randint(0, V, (B, L), generator=gen, dtype=torch.int32)
    return table, x0, noise, rand


def _copy_tokens(cfg: DataConfig, gen: torch.Generator) -> torch.Tensor:
    B, L, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
    pat = torch.randint(2, V, (B, L // 2), generator=gen, dtype=torch.int32)
    sep = torch.ones((B, 1), dtype=torch.int32)
    return torch.cat([pat, sep, pat], dim=1)[:, :L]


def synthetic_batch(cfg: DataConfig, step: int,
                    device: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Batch ``step`` on ``device`` (default: the card): ``inputs`` (B,
    L - 1) int32 tokens, or (B, L - 1, d_model) float32 embeddings in
    ``"embeddings"`` mode; ``labels`` (B, L - 1) int32, the inputs shifted
    by one; ``mask`` (B, L - 1) float32 for the copy task."""
    dev = resolve_device(device)
    gen = _gen(cfg.seed, _BATCH, step)
    if cfg.task == "lm":
        toks = lm_tokens(*_lm_draws(cfg, gen))
    else:
        toks = _copy_tokens(cfg, gen)
    inputs, labels = toks[:, :-1], toks[:, 1:]
    batch = {"labels": labels}
    if cfg.input_mode == "embeddings":
        table = torch.randn((cfg.vocab_size, cfg.d_model),
                            generator=_gen(cfg.seed, _EMBED))
        batch["inputs"] = table[inputs.long()]
    else:
        batch["inputs"] = inputs
    if cfg.task == "copy":
        mask = torch.zeros(labels.shape, dtype=torch.float32)
        mask[:, labels.shape[1] // 2:] = 1.0
        batch["mask"] = mask
    return {k: v.contiguous().to(dev) for k, v in batch.items()}


def data_iterator(cfg: DataConfig, start_step: int = 0,
                  device: Optional[str] = None
                  ) -> Iterator[Dict[str, torch.Tensor]]:
    """Infinite restart-safe iterator (resume by passing the saved step)."""
    step = start_step
    while True:
        yield synthetic_batch(cfg, step, device)
        step += 1
