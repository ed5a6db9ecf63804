"""Why the card's own SPLS plans differ from the CPU's (ROADMAP.md, C1), on
the CPU: the predictor's float32 products summed in another order -- as
the card's matmuls sum them -- change the predicted scores by an ulp, and
the quantized PAM is full of exact ties, so some top-k splits flip.  Every
flip is a near-tie: the swapped columns' scores lie within PERF.md's PAM
tolerance (1e-5 x max(1, |k-th score|)) of the row's k-th score, and on
equal inputs no field but the attention mask moves in the first layer.
"""

from __future__ import annotations

import torch

from repro_torch.core import predict
from repro_torch.core.planner import PlanContext
from repro_torch.core.quantizers import quantize_dequantize
from repro_torch.core.topk import topk_count
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.launch.train import train_config
from repro_torch.models import init_params
from repro_torch.models.common import rms_norm

PAM_TIE = 1e-5


def _reversed_sums(x, wq, wk, method="hlog", bits=8, act_axis=None):
    """``predict_qk_pre`` with the contraction summed back to front."""
    xq = quantize_dequantize(x, method, bits, axis=act_axis).flip(-1)
    q = xq @ quantize_dequantize(wq, method, bits).flip(0)
    k = xq @ quantize_dequantize(wk, method, bits).flip(0)
    return quantize_dequantize(q, method, bits, axis=act_axis), k


def test_predictor_sum_order_flips_only_near_ties(monkeypatch):
    """(path q's smoke form): layer 0 on equal inputs."""
    cfg = train_config("qwen3-0.6b", spls=True)
    params = init_params(cfg, seed=0, device="cpu")
    batch = synthetic_batch(DataConfig(vocab_size=cfg.vocab_size,
                                       seq_len=65, global_batch=8, seed=0),
                            0, "cpu")
    blk = {k: (v[0] if not isinstance(v, dict) else
               {kk: vv[0] for kk, vv in v.items()})
           for k, v in params["periods"][0].items()}
    xn = rms_norm(params["embed"][batch["inputs"]], blk["ln1"],
                  cfg.norm_eps)
    ctx = PlanContext.for_config(cfg)
    L = xn.shape[1]

    def plan_and_pam():
        qh, kh = ctx.predict_heads(blk["attn"], xn, act_axis=None)
        pam = torch.matmul(qh, kh[:, :, None].transpose(-1, -2)) \
            * ctx.Dh ** -0.5
        tri = torch.ones((L, L), dtype=torch.bool).tril()
        pam = pam.masked_fill(~tri, torch.finfo(pam.dtype).min / 2)
        return ctx.plan_exact(blk["attn"], xn), pam

    with torch.no_grad():
        cpu, pam_cpu = plan_and_pam()
        monkeypatch.setattr(predict, "predict_qk_pre", _reversed_sums)
        other, pam_other = plan_and_pam()
    diff = {f: int((a != b).sum()) for f, a, b in
            zip(cpu._fields, cpu, other)}
    assert diff["attn_mask"] > 0          # the order alone breaks ties
    assert all(v == 0 for f, v in diff.items() if f != "attn_mask"), diff
    k = topk_count(L, cfg.spls.k_ratio)
    flips = (cpu.attn_mask != other.attn_mask)
    for row in flips.any(-1).nonzero().tolist():
        r = tuple(row)
        cols = flips[r].nonzero().flatten()
        for pam in (pam_cpu, pam_other):
            kth = torch.sort(pam[r], descending=True,
                             stable=True).values[k - 1]
            gap = float((pam[r][cols] - kth).abs().max())
            assert gap <= PAM_TIE * max(1.0, abs(float(kth))), (row, gap)
