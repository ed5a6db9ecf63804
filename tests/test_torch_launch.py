"""The port's serving launcher ``python -m repro_torch.launch.serve --arch
<id> --device cpu`` for every architecture of the registry: the dense
engine, and the paged engine with SPLS where the reference's launcher runs
it (token models with attention-only periods).  Each run exits 0 with
every request done; embeddings-input archs and ``--paged`` on Mamba archs
print the reference's skip messages and exit 0 as it does.
"""

from __future__ import annotations

import json

import pytest

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch import serve


def _run(capsys, *argv):
    rc = serve.main(["--device", "cpu", *argv])
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("arch_id", ARCH_IDS)
@pytest.mark.parametrize("paged", [False, True])
def test_launcher_serves_every_arch(capsys, arch_id, paged):
    cfg = get_config(arch_id)
    extra = ["--paged", "--spls"] if paged else []
    rc, out = _run(capsys, "--arch", arch_id, "--requests", "3",
                   "--max-new", "3", *extra)
    assert rc == 0
    if cfg.input_mode != "tokens":
        assert out.strip() == (f"{cfg.name}-smoke: embeddings-input arch; "
                               "engine demo uses tokens -- skipping")
        return
    if paged and cfg.has_mamba:
        assert out.strip() == (f"{cfg.name}-smoke: hybrid/SSM arch; paged "
                               "engine is attention-only -- skipping")
        return
    res = json.loads(out)
    assert res["all_done"] and res["requests"] == res["retired"] == 3
    assert all(len(v) == 3 for v in res["outputs"].values())
    if paged:
        assert set(res["pool"]) == {"peak_pages", "preemptions",
                                    "prefill_chunks"}


def test_launcher_defaults_match_the_reference():
    """The reference's flags and defaults, plus ``--device``."""
    assert vars(serve.parser().parse_args([])) == dict(
        arch="qwen3-0.6b", requests=8, slots=4, prompt_len=16, max_new=8,
        spls=False, paged=False, page_size=8, device=None)
