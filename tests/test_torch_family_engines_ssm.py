"""Greedy tokens of the reference's dense fixed-slot engine and the
port's, on bridged weights and the same prompts, for Mamba2 (mamba2) and
the Mamba / MoE / attention hybrid (jamba, SPLS on its attention block on
and off) at their smoke form (float32): the Mamba state and conv window
are spliced into a freed slot like K / V.  Tokens exact.  The paged engine
is attention-only in both packages, and refuses them.
"""

from __future__ import annotations

import pytest

from repro_torch.serving import PagedServingEngine as TPaged
from repro_torch.serving import ServeConfig as TServe

from _torch_parity import arch_pair, dense_engines_agree, params_pair


@pytest.mark.parametrize("arch_id,spls", [
    ("mamba2-370m", False), ("jamba-v0.1-52b", False),
    ("jamba-v0.1-52b", True)])
def test_dense_engine_matches_reference(arch_id, spls):
    dense_engines_agree(arch_id, spls)


@pytest.mark.parametrize("arch_id", ["mamba2-370m", "jamba-v0.1-52b"])
def test_paged_engine_refuses_mamba_blocks(arch_id):
    jc, tc = arch_pair(arch_id)
    _, tp = params_pair(jc, jit=True)
    with pytest.raises(ValueError, match="attention-only"):
        TPaged(tc, tp, TServe(), device="cpu")
