"""The one traffic generator: a mix file's parameters and a seed -> the
requests each client sends.

The sizes are the mix's own: prompt and output lengths, and each prompt's
kind, are drawn once from the file's ``length_seed``, and each client sends
its stream in that order, so every run of a mix offers the same work at the
same points of the loop.  The run's seed draws every token.  A prompt's kind is
``random`` (uniform random tokens) or ``repeated_runs`` (runs of
``run_length`` copies of one random token, as the program's serving smoke
tests build them: ``chip_smoke.py``, paths (a) and (d)).  Repeated content
is a property a mix names, with its share in ``prompt_kinds``: SPLS skips
more work where neighbouring rows are alike, so a mix that has it and one
that has none measure different things.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import List

import numpy as np

KINDS = ("random", "repeated_runs")


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    prompt: np.ndarray        # (Lp,) int32 token ids
    output_len: int
    kind: str


def load(path) -> dict:
    return json.loads(Path(path).read_text())


def seed_int(seed: int) -> int:
    """Any whole number -> a seed every generator takes."""
    return int(seed) % (2 ** 63)


def draw_length(rng: np.random.Generator, dist: dict) -> int:
    kind = dist["dist"]
    if kind == "fixed":
        return int(dist["value"])
    if kind == "uniform":
        return int(rng.integers(dist["min"], dist["max"] + 1))
    if kind == "lognormal":
        v = dist["median"] * np.exp(dist["sigma"] * rng.standard_normal())
        return int(np.clip(round(v), dist["min"], dist["max"]))
    raise ValueError(f"unknown length distribution {kind!r}")


def make_prompt(rng: np.random.Generator, kind: str, length: int,
                vocab: int, run_length: int) -> np.ndarray:
    if kind == "random":
        toks = rng.integers(0, vocab, size=length)
    elif kind == "repeated_runs":
        toks = np.repeat(rng.integers(0, vocab, size=-(-length // run_length)),
                         run_length)[:length]
    else:
        raise ValueError(f"unknown prompt kind {kind!r}")
    return toks.astype(np.int32)


def _shapes(traffic: dict, n: int, rng: np.random.Generator) -> list:
    kinds = list(traffic["prompt_kinds"])
    share = np.asarray([traffic["prompt_kinds"][k] for k in kinds], float)
    out = []
    for _ in range(n):
        out.append((draw_length(rng, traffic["prompt_len"]),
                    draw_length(rng, traffic["output_len"]),
                    kinds[int(rng.choice(len(kinds), p=share / share.sum()))]))
    return out


def client_streams(traffic: dict, vocab: int, seed: int
                   ) -> List[List[RequestSpec]]:
    """``clients`` streams of ``requests_per_client`` requests each."""
    n_c, per = traffic["clients"], traffic["requests_per_client"]
    shapes = _shapes(traffic, n_c * per,
                     np.random.default_rng(traffic["length_seed"]))
    streams = [shapes[c * per:(c + 1) * per] for c in range(n_c)]
    rng = np.random.default_rng(seed_int(seed))
    run = traffic.get("run_length", 16)
    return [[RequestSpec(make_prompt(rng, kind, lp, vocab, run), lo, kind)
             for lp, lo, kind in stream] for stream in streams]


def warmup_requests(traffic: dict, vocab: int, seed: int
                    ) -> List[RequestSpec]:
    """The mix's warm-up requests (set-up: every shape the window uses)."""
    rng = np.random.default_rng(seed_int(seed) ^ 0x5EED)
    run = traffic.get("run_length", 16)
    return [RequestSpec(make_prompt(rng, w["kind"], w["prompt_len"], vocab,
                                    run), w["output_len"], w["kind"])
            for w in traffic["warmup"]]
