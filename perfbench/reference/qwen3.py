"""Plain PyTorch reference of a served Qwen3 token model.

Follows the published description of Qwen3 (pre-norm RMSNorm blocks,
grouped-query attention with RMSNorm on each query and key head, rotary
positions on split halves, a SwiGLU feed-forward, a tied LM head) in
float32, with no kernels, cache pages or batching.  One departure is the
parametrisation the benchmark's weights come in: an RMSNorm scales by ``1
+ scale`` (its weight minus one), as the serving program stores it.

:func:`serve_logits` replays one served request: the prompt, then every
token the program served, fed back in as a teacher would.  With SPLS it
follows the paper's streamed prefill on its own: each prompt chunk plans
its rows from the HLog predictor (:mod:`perfbench.reference.spls`), runs Q
and attention on the cross-head union of critical rows and the FFN on
FFN-critical rows, packed to the capacity given for that chunk, similar
rows taking their leader's output; after the prompt, the layer-0 head vote
decides which prompt columns decode may attend.  It imports nothing of the
program and takes no tensor the program made.

``precision="tf32"`` is the control: every float32 product rounded to TF32
on the tensor cores, the nearest precision below the configuration's.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Sequence, Tuple

import torch

from . import spls as S_


def rms_norm(x, scale, eps):
    x32 = x.float()
    out = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return out * (1.0 + scale.float())


def rope(x, positions, theta):
    """x (..., L, Dh), positions (L,)."""
    half = x.shape[-1] // 2
    inv = 1.0 / torch.pow(theta, torch.arange(half, dtype=torch.float32,
                                              device=x.device) / half)
    ang = positions.float()[:, None] * inv
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@contextlib.contextmanager
def _matmul_precision(precision: str):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Qwen3:
    """``cfg``: the configuration file's dict; ``params``: the benchmark's
    weights (``embed (V, D)``, per-layer leaves stacked on a leading axis
    under ``periods[0]``, ``final_norm``)."""

    def __init__(self, cfg: dict, params: dict, precision: str = "fp32"):
        self.D = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.KV = cfg["num_key_value_heads"]
        self.G = self.H // self.KV
        self.Dh = cfg["head_dim"]
        self.n_layers = cfg["num_hidden_layers"]
        self.theta = float(cfg["rope_theta"])
        self.eps = cfg["rms_norm_eps"]
        self.spls = cfg.get("spls")
        self.p = params
        self.precision = precision

    def layer(self, i: int) -> dict:
        blk = self.p["periods"][0]
        return {"ln1": blk["ln1"][i], "ln2": blk["ln2"][i],
                **{k: v[i] for k, v in blk["attn"].items()},
                **{k: v[i] for k, v in blk["ffn"].items()}}

    # -- pieces ------------------------------------------------------------
    def _rows_mm(self, x, w):
        """The products on packed rows: summed in float64 and rounded once,
        as the configuration states for them; under the control, float32
        on TF32."""
        if self.precision == "tf32":
            return x @ w
        return (x.double() @ w.double()).float()

    def _kv(self, lp, xn, pos):
        k = torch.einsum("bld,dkh->bklh", xn, lp["wk"])
        v = torch.einsum("bld,dkh->bklh", xn, lp["wv"])
        k = rms_norm(k, lp["k_norm"], self.eps)
        return rope(k, pos, self.theta), v

    def _q(self, lp, xn, pos, rows_mm=False):
        """xn (1, C, D) -> q (1, KV, G, C, Dh)."""
        C = xn.shape[1]
        w = lp["wq"].reshape(self.D, -1)
        q = self._rows_mm(xn[0], w) if rows_mm else xn[0] @ w
        q = q.reshape(1, C, self.KV, self.G, self.Dh).permute(0, 2, 3, 1, 4)
        return rope(rms_norm(q, lp["q_norm"], self.eps), pos, self.theta)

    def _out(self, lp, o):
        return torch.einsum("bkgld,kgdm->blm", o, lp["wo"])

    def _mlp(self, lp, xn, rows_mm=False):
        mm = self._rows_mm if rows_mm else (lambda a, b: a @ b)
        up = mm(xn, lp["w_up"]) * torch.nn.functional.silu(
            mm(xn, lp["w_gate"]))
        return up @ lp["w_down"]

    def head(self, x):
        x = rms_norm(x, self.p["final_norm"], self.eps)
        return x @ self.p["embed"].T

    def _attend(self, q, k, v, mask):
        """q (1, KV, G, C, Dh), k / v (1, KV, S, Dh), mask (..., C, S)."""
        s = torch.matmul(q, k[:, :, None].transpose(-1, -2)) \
            * self.Dh ** -0.5
        return torch.matmul(S_.masked_softmax(s, mask), v[:, :, None])

    # -- prefill -----------------------------------------------------------
    def _prefill_dense(self, tokens):
        L = tokens.shape[0]
        pos = torch.arange(L, device=tokens.device)
        x = self.p["embed"][tokens.long()][None].float()
        causal = pos[None, :] <= pos[:, None]
        ks, vs = [], []
        for i in range(self.n_layers):
            lp = self.layer(i)
            xn = rms_norm(x, lp["ln1"], self.eps)
            k, v = self._kv(lp, xn, pos)
            ks.append(k)
            vs.append(v)
            x = x + self._out(lp, self._attend(self._q(lp, xn, pos), k, v,
                                               causal))
            x = x + self._mlp(lp, rms_norm(x, lp["ln2"], self.eps))
        return self.head(x[:, -1]), ks, vs, torch.ones(
            L, dtype=torch.bool, device=tokens.device), []

    def _prefill_spls(self, tokens, chunk, caps, prune_vote, slots):
        """The streamed SPLS prefill, chunk by chunk, each chunk's rows over
        ``slots`` columns (those not yet written masked), as the serving
        engine lays a sequence out, so that every float sum of the plan
        runs over the same columns in the same order; ``caps[c]`` is chunk
        ``c``'s (Q rows, FFN rows) capacity.  Returns the first served
        token's logits, every layer's K / V of the prompt, the prompt
        columns that decode keeps, and each chunk's observed critical-row
        counts (Q union, FFN; the maximum over layers)."""
        sp = self.spls
        dev = tokens.device
        Lp = tokens.shape[0]
        S = max(slots, Lp)
        k_top = S_.topk_count(Lp, sp["k_ratio"])
        w = sp["window"]
        zeros = lambda: torch.zeros(1, self.KV, S, self.Dh, device=dev)
        ks = [zeros() for _ in range(self.n_layers)]
        vs = [zeros() for _ in range(self.n_layers)]
        pk = [zeros() for _ in range(self.n_layers)]
        votes = torch.zeros(self.H, S, dtype=torch.bool, device=dev)
        counts, first = [], None
        for ci, start in enumerate(range(0, Lp, chunk)):
            valid = min(chunk, Lp - start)
            n_cols = start + valid
            toks = torch.zeros(chunk, dtype=torch.long, device=dev)
            toks[:valid] = tokens[start:n_cols].long()
            pos = start + torch.arange(chunk, device=dev)
            cq, cf = caps[ci]
            x = self.p["embed"][toks][None].float()
            n_q = n_f = 0
            for i in range(self.n_layers):
                lp = self.layer(i)
                xn = rms_norm(x, lp["ln1"], self.eps)
                qh, kh = S_.predict_heads(xn, lp["wq"].reshape(self.D, -1),
                                          lp["wk"].reshape(self.D, -1),
                                          self.KV, self.G, self.Dh,
                                          sp.get("quant_bits", 8))
                pk[i][:, :, start:n_cols] = kh[:, :, :valid]
                pb = S_.plan_block(qh, pk[i], k=k_top, row0=start,
                                   n_valid=valid, n_cols=n_cols,
                                   s_threshold=sp["s_threshold"], window=w,
                                   f_threshold=sp["f_threshold"])
                if i == 0:
                    votes |= pb.kv_any.reshape(self.H, S)
                crit = pb.q_critical.any(dim=2).any(dim=1)       # (1, C)
                rows_ok = torch.arange(chunk, device=dev) < valid
                n_q = max(n_q, int(crit.sum()))
                n_f = max(n_f, int((pb.ffn_critical[0] & rows_ok).sum()))
                k, v = self._kv(lp, xn, pos)
                ks[i][:, :, start:n_cols] = k[:, :, :valid]
                vs[i][:, :, start:n_cols] = v[:, :, :valid]
                perm, src = S_.compact_rows(crit, cq, pb.q_leader, w)
                perm = perm[0].long()
                q = self._q(lp, xn[:, perm], pos[perm], rows_mm=True)
                o = self._attend(q, ks[i], vs[i],
                                 pb.mask.index_select(-2, perm))
                o = torch.gather(o, -2, src.long()[..., None].expand(
                    *src.shape, self.Dh))
                x = x + self._out(lp, o)
                xn2 = rms_norm(x, lp["ln2"], self.eps)
                fperm, fsrc = S_.compact_rows(pb.ffn_critical, cf,
                                              pb.ffn_leader, w)
                down = self._mlp(lp, xn2[0, fperm[0].long()], rows_mm=True)
                x = x + down[fsrc[0].long()][None]
            counts.append((n_q, n_f))
            if n_cols == Lp:
                first = self.head(x[:, valid - 1])
        need = max(1, math.ceil(prune_vote * self.H))
        keep = votes[:, :Lp].sum(0) >= need
        keep[-1] = True
        return (first, [k[:, :, :Lp] for k in ks], [v[:, :, :Lp] for v in vs],
                keep, counts)

    # -- a served request --------------------------------------------------
    @torch.no_grad()
    def serve_logits(self, prompt: Sequence[int], served: Sequence[int],
                     chunk: int, spls: bool,
                     caps: Optional[List[Tuple[int, int]]] = None,
                     prune_vote: float = 0.5, device="cuda",
                     slots: int = 0):
        """Logits (n, V) of the positions whose tokens the program served:
        the prompt's last row, then one row a served token fed back in;
        and each prompt chunk's observed critical-row counts (SPLS).
        ``slots``: the columns a sequence's prompt chunks run over (the
        engine's ``max_len`` rounded up to whole pages)."""
        with _matmul_precision(self.precision):
            tokens = torch.as_tensor(prompt, device=device)
            Lp = tokens.shape[0]
            if spls:
                if caps is None:
                    caps = [(chunk, chunk)] * (-(-Lp // chunk))
                first, ks, vs, keep, counts = self._prefill_spls(
                    tokens, chunk, caps, prune_vote, slots)
            else:
                first, ks, vs, keep, counts = self._prefill_dense(tokens)
            fed = torch.as_tensor(list(served[:-1]), device=device)
            n = fed.shape[0]
            if n == 0:
                return first.float(), counts
            kept = torch.nonzero(keep)[:, 0]
            pos = Lp + torch.arange(n, device=device)
            mask = torch.cat([torch.ones(n, kept.shape[0], dtype=torch.bool,
                                         device=device),
                              pos[None, :] <= pos[:, None]], 1)
            x = self.p["embed"][fed.long()][None].float()
            for i in range(self.n_layers):
                lp = self.layer(i)
                xn = rms_norm(x, lp["ln1"], self.eps)
                k, v = self._kv(lp, xn, pos)
                k = torch.cat([ks[i][:, :, kept], k], 2)
                v = torch.cat([vs[i][:, :, kept], v], 2)
                x = x + self._out(lp, self._attend(self._q(lp, xn, pos), k,
                                                   v, mask))
                x = x + self._mlp(lp, rms_norm(x, lp["ln2"], self.eps))
            return torch.cat([first, self.head(x[0])], 0).float(), counts


def served_gaps(logits: torch.Tensor, served: Sequence[int]) -> List[float]:
    """At each position, the gap by which the served token's logit lies
    below the reference's best there."""
    t = torch.as_tensor(list(served), device=logits.device).long()
    best = logits.amax(-1)
    return (best - logits.gather(1, t[:, None])[:, 0]).tolist()
