"""Plain PyTorch reference of the paper's BERT-Base encoder under SPLS's
exact plan.

The encoder as the paper's reproduction defines it (pre-norm RMSNorm
blocks that scale by ``1 + scale``, rotary positions, no biases, a tanh
GELU MLP, the LM head tied to the embedding as its output), in float32
with no kernels.  Each block plans before its QKV generation (the paper's
Fig. 5a): HLog-quantized Q/K prediction with per-tensor scales over the
batch, the predicted attention, an exact row top-k (ties to the earlier
column), local similarity of the sparsified rows, the column keep and the
MFI vote.  Attention then runs as the paper's accelerator lowers the plan
to block sparsity: every row over the columns its head keeps (no intra-row
mask), a row taking its leader's output, computed in float64 and rounded
once to float32, as the plan's attention is specified; the FFN runs on
every row and a row takes its MFI leader's output.

``precision="tf32"`` is the control: every float32 product on TF32, and
the attention in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import spls as S
from .qwen3 import _matmul_precision, rms_norm, rope


def row_topk_mask(scores, k):
    """Exactly ``k`` largest entries of each row; ties to the earlier
    column (a stable descending sort)."""
    if k >= scores.shape[-1]:
        return torch.ones_like(scores, dtype=torch.bool)
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    return torch.zeros_like(scores, dtype=torch.bool).scatter_(
        -1, idx[..., :k], True)


class Bert:
    def __init__(self, cfg: dict, params: dict, precision: str = "fp32"):
        self.D = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.Dh = cfg["head_dim"]
        self.n_layers = cfg["num_hidden_layers"]
        self.theta = float(cfg["rope_theta"])
        self.eps = cfg["layer_norm_eps"]
        self.spls = cfg["spls"]
        self.p = params
        self.precision = precision

    def layer(self, i: int) -> dict:
        blk = self.p["periods"][0]
        return {"ln1": blk["ln1"][i], "ln2": blk["ln2"][i],
                **{k: v[i] for k, v in blk["attn"].items()},
                **{k: v[i] for k, v in blk["ffn"].items()}}

    def plan(self, lp, xn):
        """The exact plan of one block: ``(leader (B, H, L), kv_keep (B,
        H, L), ffn_leader (B, L))``."""
        sp = self.spls
        B, L, D = xn.shape
        bits = sp.get("quant_bits", 8)
        xq = S.quantize_dequantize(xn, bits)
        qp = S.quantize_dequantize(
            xq @ S.quantize_dequantize(lp["wq"].reshape(D, -1), bits), bits)
        kp = S.quantize_dequantize(
            xq @ S.quantize_dequantize(lp["wk"].reshape(D, -1), bits), bits)
        qh = qp.reshape(B, L, self.H, 1, self.Dh).permute(0, 2, 3, 1, 4)
        kh = kp.reshape(B, L, self.H, self.Dh).permute(0, 2, 1, 3)
        pam = torch.matmul(qh, kh.unsqueeze(2).transpose(-1, -2)) \
            * self.Dh ** -0.5
        mask = row_topk_mask(pam, S.topk_count(L, sp["k_ratio"]))
        spa = torch.where(mask, pam, torch.zeros_like(pam))
        _, lead = S.local_similarity(spa, sp["window"], sp["s_threshold"], L)
        keep = mask.any(dim=-2)
        _, flead = S.mfi_ffn(lead.reshape(B, self.H, L), sp["window"],
                             sp["f_threshold"])
        return (lead.reshape(B, self.H, L), keep.reshape(B, self.H, L),
                flead)

    def attend(self, q, k, v, keep):
        """q, k, v (B, H, L, Dh); keep (B, H, L) columns."""
        wide = self.precision != "tf32"
        dt = torch.float64 if wide else torch.float32
        s = torch.matmul(q.to(dt), k.to(dt).transpose(-1, -2)) \
            * self.Dh ** -0.5
        s = s.masked_fill(~keep[:, :, None, :], float("-inf"))
        mx = s.amax(-1, keepdim=True)
        e = torch.exp(s - torch.where(torch.isfinite(mx), mx,
                                      torch.zeros_like(mx)))
        l = e.sum(-1, keepdim=True)
        o = torch.matmul(e, v.to(dt)) / torch.where(l > 0, l,
                                                    torch.ones_like(l))
        return o.float()

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, rows) -> torch.Tensor:
        """tokens (B, L) -> logits (len(rows), L, V) of the batch rows
        ``rows``: the batch is planned whole (its quantization scales span
        the batch), the LM head runs on the rows asked for."""
        with _matmul_precision(self.precision):
            B, L = tokens.shape
            pos = torch.arange(L, device=tokens.device)
            x = self.p["embed"][tokens.long()].float()
            for i in range(self.n_layers):
                lp = self.layer(i)
                xn = rms_norm(x, lp["ln1"], self.eps)
                lead, keep, flead = self.plan(lp, xn)
                q = torch.einsum("bld,dkgh->bkglh", xn, lp["wq"])[:, :, 0]
                k = torch.einsum("bld,dkh->bklh", xn, lp["wk"])
                v = torch.einsum("bld,dkh->bklh", xn, lp["wv"])
                q, k = rope(q, pos, self.theta), rope(k, pos, self.theta)
                o = self.attend(q, k, v, keep)
                o = torch.gather(o, 2, lead.long()[..., None].expand(
                    *lead.shape, self.Dh))
                x = x + torch.einsum("bkgld,kgdm->blm", o[:, :, None],
                                     lp["wo"])
                xn2 = rms_norm(x, lp["ln2"], self.eps)
                h = F.gelu(xn2 @ lp["w_up"], approximate="tanh") \
                    @ lp["w_down"]
                x = x + torch.gather(h, 1, flead.long()[..., None].expand(
                    *flead.shape, self.D))
            x = rms_norm(x[list(rows)], self.p["final_norm"], self.eps)
            return x @ self.p["embed"].T


def position_errors(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each position's largest deviation from the reference's logits, as a
    share of the reference's largest magnitude over all positions."""
    return ((got.float() - ref).abs().amax(-1) / ref.abs().max()).flatten()

