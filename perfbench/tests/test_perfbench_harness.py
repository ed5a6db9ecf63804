"""The benchmark's yardstick on the CPU: traffic, window arithmetic,
operations and bytes from shapes, the specification's names, and a tiny
rehearsal of each serving cell against the plain reference."""

import json
import math
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench.harness import controller, flops, stats, traffic
from perfbench.tests._tiny import (CELLS, ENCODING, ROOT, SERVING, SPEC,
                                   rehearse, tiny)


ALL_NUMBERS = {"served_gap": 1.0, "tokens_off_pct": 100.0}


def _metric(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), ROOT / "perfbench/metrics" /
        f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@pytest.mark.parametrize("mix", sorted({CELLS[w]["traffic"]
                                        for w in SERVING}))
def test_traffic_repeats_for_a_seed_and_keeps_its_sizes(mix):
    tr = traffic.load(ROOT / "perfbench/traffic" / f"{mix}.json")
    a = traffic.client_streams(tr, 151936, 2 ** 31 + 17)
    b = traffic.client_streams(tr, 151936, 2 ** 31 + 17)
    c = traffic.client_streams(tr, 151936, 5)
    flat = lambda s: [r for st in s for r in st]
    assert all(np.array_equal(x.prompt, y.prompt) and
               x.output_len == y.output_len for x, y in zip(flat(a), flat(b)))
    assert any(not np.array_equal(x.prompt, y.prompt)
               for x, y in zip(flat(a), flat(c)))
    sizes = lambda s: [(len(r.prompt), r.output_len, r.kind)
                       for r in flat(s)]
    assert sizes(a) == sizes(c)        # the same work, in the same order
    lo, hi = tr["prompt_len"]["min"], tr["prompt_len"]["max"]
    assert all(lo <= len(r.prompt) <= hi for r in flat(a))
    kinds = {k for k, share in tr["prompt_kinds"].items() if share > 0}
    assert {r.kind for r in flat(a)} == kinds
    runs = [r.prompt for r in flat(a) if r.kind == "repeated_runs"]
    assert all((p[:16] == p[0]).all() for p in runs)


def test_percentile_matches_numpy():
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 100):
        v = rng.random(n).tolist()
        for p in (0, 50, 95, 100):
            assert stats.percentile(v, p) == pytest.approx(
                np.percentile(v, p), rel=0, abs=1e-12)
    assert math.isnan(stats.percentile([], 95))


def test_window_arithmetic_on_hand_timelines():
    rec = {"tokens": 1500, "window_s": 3.0}
    assert _metric("tok_s")(rec) == 500.0
    assert _metric("tok_s")({"tokens": 0, "window_s": 3.0}) is None
    batches = [0.1] * 19 + [0.3]
    assert _metric("batch_p95_ms")({"batch_s": batches}) == pytest.approx(
        np.percentile(batches, 95) * 1e3)
    assert stats.gaps_in_window([0.5, 1.0, 1.5, 4.0], 0.8, 3.0) == [0.5]
    assert _metric("idle_share")({"trace": {"busy_s": 0.5},
                                  "window_s": 2.0}) == 75.0
    assert _metric("planner.flops_saved_pct")({"flops": {
        "qkv": (100.0, 50.0), "attn": (100.0, 100.0), "ffn": (200.0, 50.0),
        "kv": (10.0, 10.0)}}) == pytest.approx(50.0)


def test_flops_and_decode_bytes_by_hand():
    cfg = {"num_hidden_layers": 2, "hidden_size": 8,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "head_dim": 2, "intermediate_size": 16, "vocab_size": 10,
           "hidden_act": "silu"}
    # q 8*8, k and v 2 * 8*4, o 8*8, ffn 3 * 8*16: 576 MACs a layer
    assert flops.proj_flops(cfg) == 2 * 2 * 576
    # positions 0..2 over contexts 1, 2, 3: QK^T and AV, 4 heads of 2
    want = 3 * flops.proj_flops(cfg) + 2 * 2 * 2 * 4 * 2 * (1 + 2 + 3)
    assert flops.causal_span_flops(cfg, 0, 3) == want
    assert flops.head_flops(cfg) == 2 * 8 * 10
    # two sequences of 5 and 3 live slots: K and V rows, q and out rows
    got = flops.paged_decode_bytes(cfg, [5, 3])
    assert got == 2 * ((5 + 3) * 2 * 2 * 2 * 4 + 2 * 4 * 2 * 2 * 4)
    assert _metric("paged_decode_roofline")({"trace": {"paged_decode": {
        "bytes": flops.HBM_BYTES_PER_S * 1e-3, "device_s": 4e-3}}}) == 25.0


def test_specification_names_and_units():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    for m in metrics:
        assert name.match(m["name"]) and unit.match(m["unit"])
        assert (ROOT / "perfbench/metrics" / f"{m['name']}.py").is_file()
    for w in SPEC["workloads"]:
        assert name.match(w["name"]) and name.match(w["traffic"])
        assert len(w["why"]) <= 200
        assert (ROOT / "perfbench/traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "perfbench/limits" / f"{w['name']}.json").is_file()
    for c in SPEC["configs"]:
        assert name.match(c["name"]) and all(name.match(k)
                                             for k in c["reduced"])
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_capacity_rule_replay():
    ctl = controller.Controller(256)
    ev = []
    for n in (250, 40, 40, 40, 200, 30):
        ev.append(("pick", ctl.capacity()))
        ev.append(("obs", n))
        ctl.observe(n)
    assert ev[0] == ("pick", 256)
    assert controller.replay_mismatches(ev, 256) == 0
    bad = [("pick", 64) if e == ev[2] else e for e in ev]
    assert controller.replay_mismatches(bad, 256) >= 1


def test_encoder_batches_repeat_for_a_seed():
    from perfbench.harness import encode
    tr = traffic.load(ROOT / "perfbench/traffic/encode_b16_l384.json")
    tr.update(pool=3)
    a = encode.batches(tr, 30522, 2 ** 31 + 5, "cpu")
    assert a.shape == (3, tr["batch"], tr["seq_len"])
    assert torch.equal(a, encode.batches(tr, 30522, 2 ** 31 + 5, "cpu"))
    assert not torch.equal(a, encode.batches(tr, 30522, 6, "cpu"))
    cfg = {"num_hidden_layers": 1, "hidden_size": 4,
           "num_attention_heads": 2, "head_dim": 2,
           "intermediate_size": 8, "vocab_size": 5, "hidden_act": "gelu"}
    # 4 tokens: q, k, v, o 4 x 4 each, up and down 4 x 8; head 4 x 5;
    # attention over all 4 columns, 2 heads of 2
    want = 4 * (2 * (4 * 16 + 2 * 32) + 2 * 20) + 4 * 2 * 2 * 2 * 2 * 4
    assert encode.flops_per_batch(cfg, 1, 4) == want


@pytest.mark.parametrize("workload", ENCODING)
def test_tiny_encoder_holds_to_the_reference(workload):
    rec = rehearse(workload)
    assert rec["check"]["batches_checked"]["value"] >= 1
    assert rec["check"]["batches_off_pct"]["value"] == 0
    assert _metric("batch_p95_ms")(rec) > 0 and _metric("tok_s")(rec) > 0


@pytest.mark.parametrize("workload", SERVING)
def test_tiny_cell_holds_to_the_reference(workload):
    rec = rehearse(workload, check_limits=ALL_NUMBERS)
    chk = rec["check"]
    assert chk["requests_checked"]["value"] >= 1, (
        rec["attempted"], rec["tokens"], rec["window_s"])
    assert chk["served_gap"]["value"] <= 1e-4
    assert chk["tokens_off_pct"]["value"] == 0
    if tiny(workload)[1]["engine"]["spls"]:
        assert chk["capacity_picks_off_rule"]["value"] == 0
        # random prompts: SPLS may find nothing alike to skip
        assert 0 <= _metric("planner.flops_saved_pct")(rec) < 100
    assert rec["tokens"] > 0 and rec["attempted"] >= 4


def test_traced_tiny_cell_reads_its_spans():
    rec = rehearse("qwen3-0.6b.spls_prefill_heavy", trace=True)
    assert _metric("step.chunk_ms")(rec) > 0
    assert _metric("step.decode_tick_ms")(rec) > 0
    assert _metric("engine.ttft_p95_ms")(rec) > 0
    assert rec["trace"]["paged_decode"]["bytes"] > 0


def test_no_jax_after_a_rehearsal():
    """In a fresh process, each serving cell rehearsed at a tiny size
    leaves no module of JAX or of the JAX package loaded."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from perfbench.tests._tiny import rehearse, CELLS\n"
            "from perfbench.run import forbidden_modules\n"
            "for w in CELLS: rehearse(w, seconds=0.5)\n"
            "print(forbidden_modules())\n") % (str(ROOT / "src"), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", SPEC["workloads"][0]
         ["name"], "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
