"""The benchmark's cells at a size a CPU test run holds: the configuration
and traffic files as committed, with the widths, depth, slots, batches and
lengths cut, and the kernels' plain versions as backends."""

import importlib
import json
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in SPEC["workloads"]}
SERVING = sorted(w for w, c in CELLS.items() if c["config"] == "qwen3-0.6b")
ENCODING = sorted(set(CELLS) - set(SERVING))


def tiny(workload: str):
    cell = CELLS[workload]
    conf = next(c for c in SPEC["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    cfg.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
               head_dim=16, intermediate_size=128, vocab_size=256)
    tr = json.loads((ROOT / "perfbench/traffic" /
                     f"{cell['traffic']}.json").read_text())
    if tr["kind"] == "encode":
        tr.update(attn_backend="torch_flash", batch=4, seq_len=64, pool=4)
        return cfg, tr
    cfg.update(num_key_value_heads=2)
    eng = tr["engine"]
    eng.update(n_slots=4, prefill_chunk=32, max_len=256,
               attn_backend="torch_paged_decode",
               compute_backend=("packed_torch" if eng["spls"] else "dense"))
    tr.update(clients=4, requests_per_client=6,
              prompt_len={"dist": "uniform", "min": 20, "max": 120},
              output_len={"dist": "uniform", "min": 10, "max": 24},
              warmup=[{"prompt_len": 70, "output_len": 3, "kind": "random"},
                      {"prompt_len": 32, "output_len": 3,
                       "kind": "repeated_runs"}],
              check={"requests": 16})
    return cfg, tr


def limits(workload: str) -> dict:
    return json.loads((ROOT / "perfbench/limits" /
                       f"{workload}.json").read_text())


def rehearse(workload: str, seed: int = 7, seconds: float = 8.0,
             trace: bool = False, check_limits=None):
    cfg, tr = tiny(workload)
    runner = importlib.import_module(f"perfbench.harness.{tr['kind']}")
    return runner.run(cfg, tr, seed, seconds, trace, torch.device("cpu"),
                      check_limits or limits(workload), time.monotonic())


def correct(check: dict) -> bool:
    return all(c["value"] >= c["limit"] if c.get("at_least")
               else c["value"] <= c["limit"] for c in check.values())
