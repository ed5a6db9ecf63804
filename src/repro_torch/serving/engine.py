"""Serving engines: dense fixed-slot and block-pool paged.

:class:`ServingEngine` is the reference's baseline and parity oracle: a
dense ``n_slots x max_len`` KV cache, whole-prompt prefill into a free
slot (:func:`repro_torch.models.prefill`, the flash backends), one batched
decode per tick (:func:`repro_torch.models.decode_step`, the flash-decode
backends).

:class:`PagedServingEngine` keeps KV in a shared
:class:`~repro_torch.serving.pager.PagePool`; requests hold block tables
instead of cache rows, admission is keyed on free pages, and a dry pool
preempts the youngest sequence by page eviction.  A causal model prefills
in chunks *between* decode ticks (no head-of-line blocking).  With SPLS,
each chunk carries its slice of the progressive sparsity plan and runs in
simulation mode (``compute_backend="dense"``) or with packed compute (Q
and the FFN only on critical rows); the end-of-prefill prune vote compacts
kept KV columns so the paper's sparsity buys pool capacity, and a finite
``vote_horizon`` finalizes the vote early (at 1, with packed compute, the
K/V projection skips the pruned columns too).  Under dense compute a
prompt of at most one chunk prefills whole, as does every prompt of a
non-causal model (the paper's BERT-Base encoder): ``prefill`` through the
flash backends, then the layer-0 prune vote decides which columns reach
the pool.

Both engines pick greedily by default; ``ServeConfig(greedy=False,
temperature=T)`` samples from ``softmax(logits / T)`` by Gumbel-max on the
engine's device, from a ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.planner import horizon_update_live
from repro_torch.core.topk import topk_count
from repro_torch.device import resolve_device
from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.models.attn_backend import AUTO, site_backend
from repro_torch.observability import Telemetry, tree_bytes
from repro_torch.sparse_compute import (CapacityController, chunk_flops,
                                        is_packed, resolve_compute_backend)

from .pager import (NULL_PAGE, PagePool, init_paged_cache, init_pos_pages,
                    init_pred_cache, keep_from_votes, spls_token_votes)
from .paged_model import (compact_slots, paged_decode_step,
                          paged_prefill_chunk, paged_prefill_chunk_spls,
                          scatter_prefill)
from .scheduler import Scheduler, SchedulerConfig, SeqState

__all__ = ["Request", "ServeConfig", "ServingEngine", "PagedServingEngine"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: object                 # (Lp,) token ids: tensor, array or list
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    # filled by the engine:
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Every field of the reference's ``ServeConfig``, same defaults."""

    n_slots: int = 4
    max_len: int = 256
    greedy: bool = True
    temperature: float = 1.0
    seed: int = 0
    # attention backend (None = cfg/auto; reference names are aliases):
    # it drives the engine site it names -- prefill the forward site, ticks
    # the (paged) decode site -- and every other site takes the model
    # config's attn_backend (see _site_cfg)
    attn_backend: Optional[str] = None
    page_size: int = 16
    n_pages: Optional[int] = None   # None -> n_slots * pages(max_len) + 1
    prefill_chunk: int = 64
    max_prefills_per_tick: int = 1
    watermark: int = 0
    spls_page_prune: bool = True    # prune dead KV columns out of the pool
    spls_prune_vote: float = 0.5    # head-vote fraction a column must win
    auto_align_chunk: bool = False
    # None -> cfg.compute_backend; packed backends compute only critical
    # rows at bucketed static capacities
    compute_backend: Optional[str] = None
    capacity_buckets: Optional[Tuple[int, ...]] = None
    capacity_margin: float = 1.25
    vote_horizon: Optional[int] = None
    telemetry: bool = True


def _prompt_tokens(prompt) -> List[int]:
    if isinstance(prompt, torch.Tensor):
        return [int(t) for t in prompt.reshape(-1).tolist()]
    return [int(t) for t in np.asarray(prompt).reshape(-1)]


def _sample_tokens(logits: torch.Tensor, greedy: bool, temperature: float,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """logits (..., V) -> (...,) token ids: the argmax when ``greedy`` or
    ``temperature <= 0``, else a draw from ``softmax(logits /
    temperature)`` by Gumbel-max (``argmax(logits / T + g)``, ``g =
    -log(-log(u))``), as ``jax.random.categorical`` draws, with ``u``
    uniform in ``[tiny, 1)`` on ``logits``' device."""
    if greedy or temperature <= 0.0:
        return logits.argmax(dim=-1)
    u = torch.rand(logits.shape, generator=generator,
                   device=logits.device).clamp_(
                       min=torch.finfo(torch.float32).tiny)
    return (logits.float() / temperature - torch.log(-torch.log(u))
            ).argmax(dim=-1)


class _SamplerMixin:
    """Each engine's token picker: one generator on the engine's device,
    seeded from ``scfg.seed``, one batched draw per pick."""

    def _init_sampler(self, scfg) -> None:
        self._gen = torch.Generator(device=self.device).manual_seed(
            scfg.seed)

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        return _sample_tokens(logits, self.scfg.greedy,
                              self.scfg.temperature, self._gen)


def _validated_tokens(req, vocab: int, max_len: int) -> List[int]:
    tokens = _prompt_tokens(req.prompt)
    lp = len(tokens)
    if lp == 0:
        raise ValueError(f"request {req.rid}: empty prompt")
    if lp > max_len:
        raise ValueError(f"request {req.rid}: prompt {lp} exceeds "
                         f"max_len {max_len}")
    if min(tokens) < 0 or max(tokens) >= vocab:
        raise ValueError(f"request {req.rid}: token ids must lie in "
                         f"[0, {vocab})")
    return tokens


def _site_cfg(cfg, scfg, site: str):
    """``cfg`` with ``attn_backend`` routed to one site of the engine: the
    ServeConfig's name where it names this site, else the model config's
    (or "auto").  So ``ServeConfig.attn_backend`` pins one site and
    ``cfg.attn_backend`` another; the reference leaves the other site on
    "auto" whenever the ServeConfig names a backend."""
    name = site_backend(scfg.attn_backend, site)
    if name == AUTO:
        name = site_backend(cfg.attn_backend, site)
    return dataclasses.replace(cfg, attn_backend=name)


# ---------------------------------------------------------------------------
# dense fixed-slot engine (the baseline / parity oracle)
# ---------------------------------------------------------------------------

class ServingEngine(_SamplerMixin):
    """Continuous batching over a dense ``n_slots x max_len`` KV cache.

    ``device=None`` runs on the card and raises without one (pass
    ``device="cpu"`` to run on the CPU); ``params`` move to the device.
    """

    def __init__(self, cfg, params, scfg: ServeConfig,
                 device: Optional[str] = None):
        self.device = resolve_device(device)
        if cfg.input_mode != "tokens":
            raise ValueError("the engine serves token models")
        # the dense engine has no packed-compute path (it is the
        # simulation-mode parity oracle): say so instead of silently
        # measuring dense compute
        if is_packed(resolve_compute_backend(
                scfg.compute_backend if scfg.compute_backend is not None
                else cfg.compute_backend, sparse=cfg.spls.enabled,
                device=self.device)):
            warnings.warn(
                "ServingEngine (dense fixed-slot) executes dense compute "
                "only; the configured packed compute_backend applies to "
                "PagedServingEngine's chunked SPLS prefill and is ignored "
                "here", RuntimeWarning, stacklevel=2)
        if scfg.vote_horizon is not None:
            warnings.warn(
                "ServingEngine prefills whole prompts with the "
                "end-of-prefill prune vote; vote_horizon applies to "
                "PagedServingEngine's chunked SPLS prefill and is ignored "
                "here", RuntimeWarning, stacklevel=2)
        self.cfg, self.scfg = cfg, scfg
        self._init_sampler(scfg)
        self._cfg_fwd = _site_cfg(cfg, scfg, "forward")
        self._cfg_dec = _site_cfg(cfg, scfg, "decode")
        # SPLS configs prefill with the progressive (streaming-
        # reproducible) plan, as the reference's engines do
        self._plan_mode = "progressive" if cfg.spls.enabled else "auto"
        self.params = _to_device(params, self.device)
        self.telemetry = Telemetry(enabled=scfg.telemetry)
        self.queue: deque = deque()
        self.slots: List[Optional[Request]] = [None] * scfg.n_slots
        self.pos = np.zeros((scfg.n_slots,), np.int32)
        self.tokens = np.zeros((scfg.n_slots, 1), np.int32)
        self.cache = init_cache(cfg, scfg.n_slots, scfg.max_len,
                                device=self.device)
        self._retired: List[Request] = []

    @property
    def stats(self) -> dict:
        """Minimal stats view (the paged engine carries the full set);
        dense compute executes everything, so savings are all zero."""
        return {"retired": len(self._retired), "compute_backend": "dense",
                "flops_saved_pct": {}}

    def submit(self, req: Request) -> None:
        tokens = _validated_tokens(req, self.cfg.vocab_size,
                                   self.scfg.max_len)
        self.telemetry.request_submitted(req.rid, len(tokens))
        self.queue.append((req, tokens))

    def _admit(self) -> None:
        """Move queued requests into free slots (prefill their prompt)."""
        for s in range(self.scfg.n_slots):
            if self.slots[s] is not None or not self.queue:
                continue
            req, tokens = self.queue.popleft()
            self.telemetry.request_admitted(req.rid)
            toks = torch.tensor([tokens], dtype=torch.int32,
                                device=self.device)
            self.telemetry.span_begin("full_prefill", rid=req.rid)
            logits, cache1 = prefill(self._cfg_fwd, self.params, toks,
                                     max_len=self.scfg.max_len,
                                     plan_mode=self._plan_mode)
            # splice this row's prefilled cache into slot s, in place,
            # field by field of whatever cache each block keeps (K / V of
            # an attention block, conv window / SSM state of a Mamba one)
            for full, one in zip(self.cache, cache1):
                for f_full, f_one in zip(full, one):
                    f_full[:, s:s + 1].copy_(f_one)
            nxt = int(self._pick(logits[0, -1]))
            req.output.append(nxt)
            self.telemetry.span_end("full_prefill", rid=req.rid)
            self.telemetry.first_token(req.rid)
            self.slots[s] = req
            self.pos[s] = len(tokens)
            self.tokens[s, 0] = nxt

    def _retire(self) -> None:
        for s, req in enumerate(self.slots):
            if req is None:
                continue
            hit_eos = req.eos_id is not None and req.eos_id in req.output
            if len(req.output) >= req.max_new_tokens or hit_eos or \
                    int(self.pos[s]) >= self.scfg.max_len - 1:
                req.done = True
                self.slots[s] = None
                self._retired.append(req)
                self.telemetry.request_retired(req.rid)

    def tick(self) -> int:
        """One engine iteration; returns the number of slots decoded."""
        self._admit()
        self._retire()  # a prefill-emitted token may already hit eos/budget
        active = [s for s, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        self.telemetry.span_begin("decode_tick",
                                  args={"n_active": len(active)})
        logits, _ = decode_step(
            self._cfg_dec, self.params, self.cache,
            torch.as_tensor(self.tokens).to(self.device),
            torch.as_tensor(self.pos).to(self.device))
        nxt = self._pick(logits[:, 0]).tolist()
        for s in active:
            self.slots[s].output.append(int(nxt[s]))
        self.telemetry.span_end("decode_tick")
        self.telemetry.tokens_decoded([self.slots[s].rid for s in active])
        for s in active:
            self.pos[s] += 1
        self.tokens[:, 0] = nxt
        self._retire()
        return len(active)

    def run_until_drained(self, max_ticks: int = 10000) -> List[Request]:
        """Tick until queue and slots are empty; returns the requests that
        retired during this call, in retirement order."""
        start = len(self._retired)
        for _ in range(max_ticks):
            self.tick()
            if not self.queue and all(s is None for s in self.slots):
                break
        return self._retired[start:]


# ---------------------------------------------------------------------------
# paged engine
# ---------------------------------------------------------------------------


class PagedServingEngine(_SamplerMixin):
    """Continuous batching over the block-pool paged KV cache.

    ``device=None`` runs on the card and raises without one (pass
    ``device="cpu"`` to run on the CPU); ``params`` move to the device.
    """

    def __init__(self, cfg, params, scfg: ServeConfig,
                 device: Optional[str] = None):
        self.device = resolve_device(device)
        if cfg.input_mode != "tokens":
            raise ValueError("the engine serves token models")
        if not all(b.mixer == "attn" for b in cfg.period):
            raise ValueError("the paged engine is attention-only (SSM state "
                             "is O(1) per slot)")
        # chunked prefill needs causal cross-chunk attention; a non-causal
        # model prefills each prompt whole (and never uses the chunk
        # path's compute backend, so any backend is accepted)
        self._chunkable = cfg.causal
        if cfg.spls.enabled and self._chunkable \
                and scfg.prefill_chunk % cfg.spls.window:
            if scfg.auto_align_chunk:
                aligned = -(-scfg.prefill_chunk // cfg.spls.window) \
                    * cfg.spls.window
                warnings.warn(
                    f"prefill_chunk ({scfg.prefill_chunk}) is not a "
                    f"multiple of the SPLS similarity window "
                    f"({cfg.spls.window}); auto_align_chunk rounded it "
                    f"up to {aligned}", RuntimeWarning, stacklevel=2)
                scfg = dataclasses.replace(scfg, prefill_chunk=aligned)
            else:
                raise ValueError(
                    f"prefill_chunk ({scfg.prefill_chunk}) must be a "
                    f"multiple of the SPLS similarity window "
                    f"({cfg.spls.window}): chunk boundaries must align "
                    f"with similarity windows for chunked prefill to "
                    f"reproduce the full-prefill plan (set "
                    f"ServeConfig.auto_align_chunk=True to round up)")
        self._compute = resolve_compute_backend(
            scfg.compute_backend if scfg.compute_backend is not None
            else cfg.compute_backend, sparse=cfg.spls.enabled,
            device=self.device)
        self._prune = cfg.spls.enabled and scfg.spls_page_prune
        # horizon-finalized column votes (core.planner): a finite horizon
        # needs the streaming chunked path and page pruning (the horizon
        # decision is a prune decision), with the end-of-prefill vote's
        # cross-head bar
        self._horizon = scfg.vote_horizon
        self._vote_need = max(1, math.ceil(scfg.spls_prune_vote
                                           * cfg.n_heads))
        if self._horizon is not None:
            if self._horizon < 1:
                raise ValueError(
                    f"vote_horizon must be >= 1 chunks (or None for the "
                    f"end-of-prefill vote), got {self._horizon}")
            if not (self._prune and self._chunkable):
                raise ValueError(
                    "vote_horizon requires SPLS (cfg.spls.enabled), page "
                    "pruning (ServeConfig.spls_page_prune) and a causal "
                    "model (chunked prefill): the horizon finalizes the "
                    "streaming prune vote early")
        self._attn_backend = _site_cfg(cfg, scfg,
                                       "paged_decode").attn_backend
        self._cfg_fwd = _site_cfg(cfg, scfg, "forward")
        self._plan_mode = "progressive" if cfg.spls.enabled else "auto"
        self.cfg, self.scfg = cfg, scfg
        self._init_sampler(scfg)
        self.params = _to_device(params, self.device)

        ps = scfg.page_size
        self.page_size = ps
        self.pages_per_seq = math.ceil(scfg.max_len / ps)
        n_pages = (scfg.n_pages if scfg.n_pages is not None
                   else scfg.n_slots * self.pages_per_seq + 1)
        self.pool = PagePool(n_pages, ps)
        cs = scfg.prefill_chunk
        self._cap_q = self._cap_f = self._cap_kv = None
        if is_packed(self._compute):
            cap = lambda: CapacityController(
                cs, buckets=scfg.capacity_buckets,
                margin=scfg.capacity_margin)
            self._cap_q, self._cap_f = cap(), cap()
            # the K/V projection capacity: only vote_horizon == 1 decides
            # before K/V generation
            if self._horizon == 1:
                self._cap_kv = cap()
        self.telemetry = Telemetry(enabled=scfg.telemetry)
        self.sched = Scheduler(
            SchedulerConfig(n_slots=scfg.n_slots,
                            prefill_chunk=scfg.prefill_chunk,
                            max_prefills_per_tick=scfg.max_prefills_per_tick,
                            watermark=scfg.watermark),
            self.pool, scfg.max_len, chunkable=self._chunkable,
            prune_aware=self._prune,
            # packed compute routes every prompt of a causal model through
            # the chunk path, so short prompts get token compaction too;
            # under dense compute a prompt of one chunk prefills whole
            chunk_all=is_packed(self._compute), telemetry=self.telemetry)

        self.cache = init_paged_cache(cfg, n_pages, ps, self.device)
        self.pos_pages = init_pos_pages(n_pages, ps, self.device)
        # allocated lazily on the first chunk, as in the reference
        self.pred_cache = None
        self._n_pages = n_pages
        self._retired: List[Request] = []
        self.telemetry.sparsity.note_pool_bytes(tree_bytes(self.cache))

    # ------------------------------------------------------------------
    @property
    def stats(self) -> dict:
        """Scheduler counters, pool gauges and capacity-controller
        snapshots, assembled fresh per read."""
        out = {**self.sched.stats,
               "pages_in_use": self.pool.pages_in_use,
               "peak_pages": self.pool.peak_in_use,
               "free_pages": self.pool.free_pages,
               "guard_trips": self.pool.guard_trips,
               "compute_backend": self._compute,
               "flops_saved_pct": self.sched.flops_saved_pct()}
        if self._cap_q is not None:
            out["capacity_q"] = self._cap_q.snapshot()
            out["capacity_ffn"] = self._cap_f.snapshot()
        if self._cap_kv is not None:
            out["capacity_kv"] = self._cap_kv.snapshot()
        return out

    def submit(self, req: Request) -> None:
        tokens = _validated_tokens(req, self.cfg.vocab_size,
                                   self.scfg.max_len)
        self.sched.submit(req, tokens, req.max_new_tokens)
        self.telemetry.request_submitted(req.rid, len(tokens))

    # ------------------------------------------------------------------
    def _table_row(self, st: SeqState) -> np.ndarray:
        row = np.full((self.pages_per_seq,), NULL_PAGE, np.int32)
        row[:len(st.pages)] = st.pages
        return row

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def _dest_slots(self, st: SeqState, n: int) -> np.ndarray:
        """(n,) flat page-slot destinations for logical slots [0, n)."""
        pages = np.asarray(st.pages, np.int64)
        sl = np.arange(n)
        return pages[sl // self.page_size] * self.page_size \
            + sl % self.page_size

    def _full_prefill(self, st: SeqState) -> None:
        """Whole-prompt prefill (any prompt of a non-causal model; under
        dense compute, a causal model's prompt of at most one chunk):
        ``prefill`` through the forward backends, the layer-0 prune vote,
        and the kept columns scattered into the sequence's pages."""
        tel = self.telemetry
        tel.span_begin("full_prefill", rid=st.req.rid,
                       args={"prompt_len": st.prompt_len})
        toks = self._tensor(np.asarray(st.tokens, np.int32))[None, :]
        logits, dense_cache = prefill(self._cfg_fwd, self.params, toks,
                                      plan_mode=self._plan_mode)
        if self._prune:
            votes = spls_token_votes(self.cfg, self.params, toks[0])
            keep = keep_from_votes(votes.cpu().numpy(), self.cfg.n_heads,
                                   self.scfg.spls_prune_vote)
        else:
            keep = np.ones((st.prompt_len,), bool)
        keep_idx = np.nonzero(keep)[0]
        n_kept = len(keep_idx)
        if not self.sched.grow_to(st, n_kept):
            # st itself was preempted (span unwound by the preempt/abort
            # telemetry); prefill recomputes later
            return
        scatter_prefill(self.cache, self.pos_pages, dense_cache,
                        self._tensor(keep_idx.astype(np.int32)),
                        self._tensor(self._dest_slots(st, n_kept)))
        st.kv_len = n_kept
        st.cur_pos = st.prompt_len
        st.prefilled = st.prompt_len
        # whole-prompt prefill runs simulation-mode compute (packed
        # capacities apply on the chunked path): charged dense == executed
        self.sched.note_flops(chunk_flops(self.cfg, st.prompt_len,
                                          st.prompt_len))
        if self._prune:
            self.sched.note_prune(st.prompt_len, n_kept)
            tel.sparsity.note_prune(st.prompt_len, n_kept)
        tel.span_end("full_prefill", rid=st.req.rid, args={"kept": n_kept})
        self._emit_first(st, logits[0, -1])

    def _chunk_prefill(self, st: SeqState) -> None:
        tel = self.telemetry
        cs = self.sched.cfg.prefill_chunk
        start = st.prefilled     # == st.kv_len: columns stay dense until
        #                          the end-of-prefill compaction
        valid = min(cs, st.prompt_len - start)
        if not self.sched.grow_to(st, start + valid):
            return   # preempted/aborted; telemetry unwound the track
        tel.span_begin("prefill_chunk", rid=st.req.rid,
                       args={"start": start, "valid": valid})
        chunk = np.zeros((cs,), np.int32)
        chunk[:valid] = st.tokens[start:start + valid]
        table = self._tensor(self._table_row(st))
        toks = self._tensor(chunk)[None, :]
        if self.cfg.spls.enabled:
            logits = self._spls_chunk(st, start, valid, table, toks)
        else:
            logits = paged_prefill_chunk(self.cfg, self.params, self.cache,
                                         self.pos_pages, table, start, toks,
                                         valid)
            self.sched.note_flops(chunk_flops(self.cfg, cs, start + valid))
        st.prefilled += valid
        st.kv_len += valid
        st.cur_pos += valid
        self.sched.stats["prefill_chunks"] += 1
        tel.span_end("prefill_chunk", rid=st.req.rid)
        if st.phase == "decode":
            if self._prune:
                self._finish_chunk_prune(st)
            self._emit_first(st, logits[0, 0])

    def _spls_chunk(self, st: SeqState, start: int, valid: int,
                    table: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
        """One SPLS chunk step: the plan block, the chunk's compute, the
        vote accumulator, the horizon's liveness and the capacity
        controllers' observations.  Returns the chunk's logits."""
        tel = self.telemetry
        cs = self.sched.cfg.prefill_chunk
        if self.pred_cache is None:
            self.pred_cache = init_pred_cache(self.cfg, self._n_pages,
                                              self.page_size, self.device)
            tel.sparsity.note_pool_bytes(tree_bytes(self.cache),
                                         tree_bytes(self.pred_cache))
        k = topk_count(st.prompt_len, self.cfg.spls.k_ratio)
        packed = self._cap_q is not None
        cq = self._cap_q.capacity() if packed else None
        cf = (self._cap_f.capacity()
              if packed and self.cfg.spls.ffn_sparsity else None)
        ckv = self._cap_kv.capacity() if self._cap_kv is not None else None
        last_keep = st.prompt_len - 1
        live = None
        if self._horizon is not None:
            if st.live is None:
                st.live = np.ones((self.pages_per_seq * self.page_size,),
                                  bool)
            live = self._tensor(st.live)
        logits, kv_any, counts = paged_prefill_chunk_spls(
            self.cfg, self.params, self.cache, self.pred_cache,
            self.pos_pages, table, start, toks, valid, k, q_capacity=cq,
            ffn_capacity=cf, kv_capacity=ckv, compute_backend=self._compute,
            live=live, last_keep=last_keep, kv_vote_need=self._vote_need)
        if self._prune:
            # cross-chunk vote accumulator: a head's "some row kept this
            # column" bit only ever turns on, so OR is exact
            votes = kv_any.reshape(self.cfg.n_heads, -1).cpu().numpy()
            st.head_votes = (votes if st.head_votes is None
                             else st.head_votes | votes)
        if self._horizon is not None:
            # finalize columns whose probation expired below the vote bar,
            # and mirror the device's kv_capacity pack of this chunk's own
            # columns (core.planner owns both)
            st.live = horizon_update_live(
                st.live, st.head_votes.sum(axis=0), start=start,
                valid=valid, chunk=cs, horizon=self._horizon,
                last_keep=last_keep, vote_need=self._vote_need,
                kv_capacity=ckv, metrics=tel.metrics)
        if packed:
            # the host readback of the critical counts syncs on the chunk
            # step; only packed compute reads them (dense has no capacity)
            n_q, n_f, n_kv = (int(v) for v in counts.amax(dim=0).tolist())
            self._cap_q.observe(n_q)
            if n_q > cq:
                self._cap_q.note_overflow()
            tel.sparsity.note_capacity("q", cq, n_q, n_q > cq)
            if self.cfg.spls.ffn_sparsity:
                self._cap_f.observe(n_f)
                if n_f > cf:
                    self._cap_f.note_overflow()
                tel.sparsity.note_capacity("ffn", cf, n_f, n_f > cf)
            if ckv is not None:
                self._cap_kv.observe(n_kv)
                if n_kv > ckv:
                    self._cap_kv.note_overflow()
                tel.sparsity.note_capacity("kv", ckv, n_kv, n_kv > ckv)
        self.sched.note_flops(chunk_flops(self.cfg, cs, start + valid,
                                          q_rows=cq, ffn_rows=cf,
                                          kv_rows=ckv))
        return logits

    def _finish_chunk_prune(self, st: SeqState) -> None:
        """Threshold the accumulated head votes once every prompt row has
        voted, compact kept columns (in original order) into the front of
        the sequence's own pages, and free the tail."""
        tel = self.telemetry
        tel.span_begin("prune_compact", rid=st.req.rid)
        Lp = st.prompt_len
        S = self.pages_per_seq * self.page_size
        tel.sparsity.note_votes(st.head_votes[:, :Lp])
        votes = st.head_votes.sum(axis=0).astype(np.int32)
        keep = keep_from_votes(votes[:Lp], self.cfg.n_heads,
                               self.scfg.spls_prune_vote)
        if st.live is not None:
            # horizon-finalized columns are gone even if they gathered
            # votes later, and an own column the kv_capacity pack dropped
            # was never projected (the decode anchor stays live)
            keep &= st.live[:Lp]
        n_kept = int(keep.sum())
        keep_slots = np.zeros((S,), bool)
        keep_slots[:Lp] = keep
        compact_slots(self.cache, self.pos_pages,
                      self._tensor(self._table_row(st)),
                      self._tensor(keep_slots))
        needed = self.pool.pages_for(n_kept)
        if needed < len(st.pages):
            self.pool.free(st.pages[needed:])
            st.pages = st.pages[:needed]
        st.kv_len = n_kept
        st.head_votes = None
        self.sched.note_prune(Lp, n_kept)
        tel.sparsity.note_prune(Lp, n_kept)
        tel.span_end("prune_compact", rid=st.req.rid,
                     args={"kept": n_kept, "prompt_len": Lp})

    def _emit_first(self, st: SeqState, logits_row: torch.Tensor) -> None:
        st.req.output.append(int(self._pick(logits_row)))
        st.budget -= 1
        self.telemetry.first_token(st.req.rid)

    # ------------------------------------------------------------------
    def tick(self) -> int:
        """One engine iteration; returns the number of slots decoded."""
        self.sched.admit()
        for st in self.sched.plan_prefills():
            if self.sched.slots[st.slot] is not st:
                continue  # preempted by an earlier prefill this tick
            if self.sched.use_chunks(st.prompt_len):
                self._chunk_prefill(st)
            else:
                self._full_prefill(st)
        self._retire_finished()  # prefill-emitted token may hit eos/budget

        # grow pages for every decode-ready row (may preempt the youngest)
        for st in list(self.sched.decode_ready()):
            if self.sched.slots[st.slot] is not st or st.budget <= 0:
                continue
            self.sched.grow_to(st, st.kv_len + 1)
        active = [st for st in self.sched.decode_ready() if st.budget > 0
                  and len(st.pages) * self.page_size > st.kv_len]

        n_decoded = 0
        if active:
            self.telemetry.span_begin("decode_tick",
                                      args={"n_active": len(active)})
            n_slots = self.scfg.n_slots
            tables = np.full((n_slots, self.pages_per_seq), NULL_PAGE,
                             np.int32)
            kv_len = np.zeros((n_slots,), np.int32)
            cur_pos = np.zeros((n_slots,), np.int32)
            tokens = np.zeros((n_slots, 1), np.int32)
            for st in active:
                tables[st.slot] = self._table_row(st)
                kv_len[st.slot] = st.kv_len
                cur_pos[st.slot] = st.cur_pos
                tokens[st.slot, 0] = st.req.output[-1]
            logits = paged_decode_step(
                self.cfg, self.params, self.cache, self.pos_pages,
                self._tensor(tables), self._tensor(kv_len),
                self._tensor(cur_pos), self._tensor(tokens),
                backend=self._attn_backend)
            nxt = self._pick(logits[:, 0]).tolist()
            for st in active:
                st.req.output.append(int(nxt[st.slot]))
                st.kv_len += 1
                st.cur_pos += 1
                st.budget -= 1
            n_decoded = len(active)
            self.telemetry.span_end("decode_tick")
            self.telemetry.tokens_decoded([st.req.rid for st in active])

        self._retire_finished()
        # sample after retirement so a drained pool reads 0 in the gauge
        self.telemetry.sparsity.observe_pool(self.pool)
        return n_decoded

    def _retire_finished(self) -> None:
        # requests the scheduler aborted (optimistic admission that never
        # fit; see Scheduler.grow_to) retire with whatever they generated
        for req in self.sched.aborted:
            req.done = True
            self._retired.append(req)
            self.telemetry.request_aborted(req.rid)
        self.sched.aborted.clear()
        for st in list(self.sched.active()):
            req = st.req
            hit_eos = req.eos_id is not None and req.eos_id in req.output
            if (st.phase == "decode"
                    and (st.budget <= 0 or hit_eos
                         or st.cur_pos >= self.scfg.max_len - 1)):
                req.done = True
                self.sched.retire(st)
                self._retired.append(req)
                self.telemetry.request_retired(req.rid)

    def run_until_drained(self, max_ticks: int = 10000) -> List[Request]:
        """Tick until everything drains; returns the requests retired
        during this call, in retirement order."""
        start = len(self._retired)
        for _ in range(max_ticks):
            self.tick()
            if self.sched.idle():
                break
        return self._retired[start:]


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_device(v, device) for v in tree)
    return tree.to(device)
