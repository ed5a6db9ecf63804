"""The token model: parameters, whole-sequence forward, prefill and
one-token decode over a contiguous cache.

The layer stack is ``cfg.period`` (a tuple of blocks) repeated
``cfg.n_periods`` times.  Parameters keep the reference's tree: period
leaves are stacked on a leading ``(n_periods, ...)`` axis, so bridging
weights from the reference package is a plain copy
(:func:`repro_torch.weights.params_from_jax`).  Where the reference
traverses the stack with ``lax.scan``, the port runs a Python loop over
periods.  The paged serving path runs its own loop around the paged cache
and uses :func:`embed_inputs` / :func:`head_logits` as seams.

``cfg.remat`` recomputes each period in backward
(``torch.utils.checkpoint``, non-reentrant), as the reference wraps its
period body in ``jax.checkpoint`` -- only while autograd records; serving
runs no checkpoint.  :func:`loss_fn` is the reference's cross-entropy
loss.

The embedding, the period boundaries and the logits carry the reference's
sharding constraints (``constrain``: a no-op on plain tensors).  On the
``DTensor`` inputs of the dry run the weights gather their ZeRO shards
before use, the lookup is vocabulary-parallel and the loss reduces over
vocabulary shards instead of gathering them.

Modality frontends (the audio / vlm archs) are stubs, as in the
reference: with ``cfg.input_mode == "embeddings"`` the model consumes
precomputed frame / patch embeddings of shape (B, L, D) instead of token
ids.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device, route_as, route_platform
from repro_torch.sharding.logical import arange_like, constrain, is_dtensor
from repro_torch.sharding.rules import unshard_fsdp

from .blocks import (block_decode, block_forward, init_block,
                     init_block_cache)
from .common import dense_init, dtype_of, rms_norm, softcap

__all__ = ["init_block", "init_params", "abstract_params", "abstract_cache",
           "embed_inputs", "head_logits", "period_params", "forward",
           "loss_fn", "init_cache", "decode_step", "prefill"]

Params = Dict[str, Any]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _stacked(make, n: int):
    """``n`` trees from ``make()``, stacked leaf by leaf on a new leading
    axis; each tree is copied into place as it is drawn, so at most one
    unstacked tree exists beside the stack."""
    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((n,) + tuple(t.shape))

    tree = make()
    out = alloc(tree)
    for i in range(n):
        if i:
            tree = make()
        for dst, src in zip(_leaves(out), _leaves(tree)):
            dst[i].copy_(src)
        tree = None
    return out


def init_params(cfg, seed: int = 0,
                device: Optional[str] = None) -> Params:
    """Random parameters from ``seed``, drawn by a ``torch.Generator`` on
    ``device`` (default: the card), so a seed gives the same weights on
    every device of one type; a full-width model of billions of parameters
    never passes through the host.  On the ``meta`` device nothing is
    drawn or allocated (:func:`abstract_params`)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.param_dtype)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev
                          ).manual_seed(seed)
    p: Params = {"embed": dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                     dtype, dev, fan_in=cfg.d_model)}
    p["periods"] = tuple(
        _stacked(lambda: init_block(cfg, blk, gen, dtype, dev),
                 cfg.n_periods)
        for blk in cfg.period)
    p["final_norm"] = torch.zeros((cfg.d_model,), dtype=dtype, device=dev)
    if not cfg.tied_embeddings:
        p["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype,
                                  dev, fan_in=cfg.d_model)
    return p


def abstract_params(cfg) -> Params:
    """The parameter tree of :func:`init_params` on the ``meta`` device:
    every leaf's shape and dtype, no storage (the reference's
    ``jax.eval_shape(init_params)``)."""
    return init_params(cfg, device="meta")


def abstract_cache(cfg, batch: int, max_len: int) -> tuple:
    """The decode cache of :func:`init_cache` on the ``meta`` device (the
    reference's ``jax.eval_shape(init_cache)``)."""
    return init_cache(cfg, batch, max_len, device="meta")


def embed_inputs(cfg, params: Params, inputs: torch.Tensor) -> torch.Tensor:
    """Token / embedding frontend: (B, L) int or (B, L, D) -> (B, L, D) in
    the compute dtype (scaled by sqrt(d_model), rounded to that dtype, when
    ``cfg.scale_embedding``)."""
    dtype = dtype_of(cfg.compute_dtype)
    if cfg.input_mode == "tokens" and is_dtensor(params["embed"]):
        # DTensor's vocab-parallel lookup (masked rows, then a sum)
        x = torch.nn.functional.embedding(
            inputs.long(), unshard_fsdp(params["embed"])).to(dtype)
    elif cfg.input_mode == "tokens":
        x = params["embed"][inputs.long()].to(dtype)
    else:  # modality stub: precomputed embeddings
        x = inputs.to(dtype)
    if cfg.scale_embedding:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype,
                             device=x.device)
    return constrain(x, ("batch", "seq", "embed"))


def head_logits(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head (tied: ``x @ embed.T``): (B, L, D) -> (B, L,
    V)."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tied_embeddings else params["lm_head"]
    if gathers_zero(x):
        w = unshard_fsdp(w)
    return constrain(softcap(x @ w.to(x.dtype), cfg.final_softcap),
                     ("batch", "seq", "vocab"))


def gathers_zero(x: torch.Tensor) -> bool:
    """Whether a step on activations ``x`` gathers its weights' ZeRO shards
    (the ``fsdp`` binding of :func:`~repro_torch.sharding.rules.
    param_sharding`) before use: yes, unless ``x`` is a ``DTensor`` whose
    rows leave the data axis unbound (a batch of one, ``long_500k``).  Then
    each data rank keeps its shard of a weight and computes its share of a
    product over it, the partial sums reduced after, as the reference's
    program does, where a gathered weight would have every data rank
    compute the whole product."""
    if not is_dtensor(x):
        return True
    names = x.device_mesh.mesh_dim_names
    return ("data" not in names
            or not x.placements[names.index("data")].is_replicate())


def period_params(params: Params, pi: int, dtype,
                  gather: bool = True) -> tuple:
    """Period ``pi``'s block params: views into the stacked leaves, cast to
    the compute dtype (a no-op view when it already matches); with
    ``gather`` a ``DTensor`` leaf's ZeRO shards gathered
    (:func:`~repro_torch.sharding.rules.unshard_fsdp`; see
    :func:`gathers_zero`)."""
    def one(t):
        if isinstance(t, dict):
            return {k: one(v) for k, v in t.items()}
        t = t[pi].to(dtype) if t.is_floating_point() else t[pi]
        return unshard_fsdp(t) if gather else t
    return tuple(one(bp) for bp in params["periods"])


def _period(cfg, params: Params, pi: int, x: torch.Tensor,
            platform: Optional[str] = None) -> torch.Tensor:
    """Period ``pi``'s blocks on ``x``; ``platform`` is the routing of the
    forward that a recompute in backward must repeat (autograd runs
    backward on its own threads, which do not see the caller's
    :func:`~repro_torch.device.route_as`)."""
    # layer-boundary activations shard their sequence over the model axis
    # (Megatron sequence parallelism), as the reference's
    x = constrain(x, ("batch", "act_seq", "embed"))
    with route_as(platform):
        for blk, bp in zip(cfg.period, period_params(
                params, pi, dtype_of(cfg.compute_dtype))):
            x = block_forward(cfg, blk, bp, x)
    return x


def _records(params: Params, x: torch.Tensor) -> bool:
    """True while autograd records the forward (grad mode on and the
    activations or a period weight require grad)."""
    return torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for bp in params["periods"] for t in _leaves(bp)))


def forward(cfg, params: Params, inputs: torch.Tensor) -> torch.Tensor:
    """inputs: (B, L) int tokens or (B, L, D) embeddings -> logits (B, L,
    V).  With SPLS on, each
    block runs under its exact-top-k plan (``plan_mode="auto"``; the
    row-block plan from ``blocks._SPLS_CHUNK_THRESHOLD`` tokens on).
    With ``cfg.remat``, while autograd records, each period is
    recomputed in backward instead of keeping its activations."""
    x = embed_inputs(cfg, params, inputs)
    remat = cfg.remat and _records(params, x)
    platform = route_platform()
    for pi in range(cfg.n_periods):
        if remat:
            x = checkpoint(_period, cfg, params, pi, x, platform,
                           use_reentrant=False)
        else:
            x = _period(cfg, params, pi, x, platform)
    return head_logits(cfg, params, x)


def loss_fn(cfg, params: Params, batch: Dict[str, torch.Tensor]):
    """Cross-entropy LM loss.  batch: ``{inputs, labels[, mask]}``.

    Returns ``(loss, metrics)``: the mean over the mask (denominator at
    least 1) of ``logsumexp - gold`` on float32 logits, and ``loss``,
    ``accuracy`` (argmax == label, masked) and ``tokens`` (the mask's sum)
    as detached scalars."""
    logits = forward(cfg, params, batch["inputs"]).float()
    labels = batch["labels"].long()
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=logits.device)
    if is_dtensor(logits):
        # over vocabulary shards: reductions across them, no gather of the
        # vocabulary; accuracy counts a label whose logit is the row's max
        # (per-token terms laid out by rows, so that their gradients reach
        # the vocabulary shards whole)
        tok = ("batch", "seq")
        top = logits.detach().amax(-1, keepdim=True)
        logz = top[..., 0] + torch.log(
            constrain(torch.exp(logits - top).sum(-1), tok))
        vocab = constrain(arange_like(logits, logits.shape[-1]), ("vocab",))
        gold = constrain(torch.where(vocab == labels[..., None], logits,
                                     0.0).sum(-1), tok)
        hit = lambda: gold.detach() >= top[..., 0]
    else:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None])[..., 0]
        hit = lambda: logits.argmax(-1) == labels
    nll = (logz - gold) * mask
    denom = mask.sum().clamp(min=1.0)
    loss = nll.sum() / denom
    with torch.no_grad():
        acc = hit().float()
        metrics = {"loss": loss.detach(),
                   "accuracy": (acc * mask).sum() / denom,
                   "tokens": mask.sum()}
    return loss, metrics


def init_cache(cfg, batch: int, max_len: int,
               device: Optional[str] = None) -> tuple:
    """One cache per period block, stacked over periods, zeros on
    ``device`` (default: the card): a
    :class:`~repro_torch.models.attention.KVCache` ``k / v (n_periods, B,
    KV, max_len, Dh)`` in the compute dtype for an attention block, a
    :class:`~repro_torch.models.mamba.MambaCache` (``conv (n_periods, B,
    channels, W)`` in the compute dtype, ``ssd (n_periods, B, H, P, N)``
    float32) for a Mamba block."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.compute_dtype)
    return tuple(init_block_cache(cfg, blk, (cfg.n_periods, batch), max_len,
                                  dtype, dev) for blk in cfg.period)


def decode_step(cfg, params: Params, cache: tuple, tokens: torch.Tensor,
                pos: torch.Tensor):
    """One decode step.  tokens: (B, 1) int or (B, 1, D); pos: (B,) int32
    write index (attention blocks).

    Every layer updates its slice of ``cache`` **in place** (the reference
    threads a new cache through its scan).  Returns ``(logits (B, 1, V),
    cache)``.
    """
    dtype = dtype_of(cfg.compute_dtype)
    x = embed_inputs(cfg, params, tokens)
    gather = gathers_zero(x)
    for pi in range(cfg.n_periods):
        for blk, bp, c in zip(cfg.period,
                              period_params(params, pi, dtype, gather),
                              cache):
            x, _ = block_decode(cfg, blk, bp, x,
                                type(c)(*(f[pi] for f in c)), pos)
    return head_logits(cfg, params, x), cache


def prefill(cfg, params: Params, inputs: torch.Tensor,
            max_len: Optional[int] = None, plan_mode: str = "auto"):
    """Process a whole prompt: inputs (B, L) int or (B, L, D) ->
    ``(logits (B, L, V), cache)`` with the cache as :func:`init_cache` lays
    it out, right-padded to ``max_len`` (default L).

    With SPLS on this is the paper's scenario: each block's plan is
    predicted before its QKV generation and the prompt runs sparsely
    (``plan_mode="progressive"``, the streaming-reproducible plan the
    serving engines use); the cache still holds every position.
    """
    L = inputs.shape[1]
    S = max_len or L
    dtype = dtype_of(cfg.compute_dtype)
    x = embed_inputs(cfg, params, inputs)
    per_period = []
    for pi in range(cfg.n_periods):
        caches = []
        for blk, bp in zip(cfg.period, period_params(params, pi, dtype)):
            x, c = block_forward(cfg, blk, bp, x, cache_len=S,
                                 plan_mode=plan_mode)
            caches.append(c)
        per_period.append(caches)
    cache = tuple(
        type(c0)(*(torch.stack([cs[bi][f] for cs in per_period])
                   for f in range(len(c0))))
        for bi, c0 in enumerate(per_period[0]))
    return head_logits(cfg, params, x), cache
