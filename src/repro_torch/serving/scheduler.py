"""Continuous-batching scheduler: chunked prefill, admission, preemption.

A copy of the reference package's host-side scheduler with its imports
re-pointed; the port keeps its own.

Pure host-side policy over the :class:`~repro_torch.serving.pager.PagePool`; the
engine executes whatever the scheduler decides.  The dataflow per tick:

1. **admit** -- waiting requests move into free batch slots while the pool
   can cover their first unit of work (admission control is keyed on free
   pages, not slots alone).
2. **prefill** -- at most ``max_prefills_per_tick`` prefill-phase sequences
   advance by one prompt chunk.  Decode never waits for a whole prompt:
   a 10k-token prefill is sliced into ``prefill_chunk``-token pieces
   interleaved with decode ticks (no head-of-line blocking).  With SPLS
   the chunk also carries its slice of the progressive sparsity plan; the
   page-prune vote finalizes with the last chunk, after which the engine
   compacts kept columns and the freed pages come back here.
3. **decode** -- every decode-phase sequence produces one token.  Crossing
   a page boundary allocates a page on demand; when the pool is dry the
   youngest other sequence is **preempted by page eviction**: its pages go
   back to the free list and the request re-queues at the *front* of the
   waiting line with its generated tokens folded into the prompt
   (recompute-style preemption -- greedy decoding reproduces the identical
   continuation after re-prefill, *unless* SPLS page pruning is on: the
   resume re-plans over the extended sequence and may prune a different
   column set, so pruned outputs can depend on pool pressure).

Sequences whose worst-case footprint (prompt + max_new tokens) exceeds the
pool are rejected at submit: they could never run.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import List, Optional

from repro_torch.observability import CounterDictView, Telemetry
from repro_torch.sparse_compute.accounting import saved_pct

from .pager import PagePool

__all__ = ["SchedulerConfig", "SeqState", "Scheduler"]

_STAT_KEYS = ("admitted", "preemptions", "retired", "prefill_chunks",
              "aborted")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    n_slots: int = 4
    prefill_chunk: int = 64        # prompt tokens advanced per prefill tick
    max_prefills_per_tick: int = 1  # chunked-prefill fairness knob
    watermark: int = 0              # free pages held back at admission
    # post-prune estimate smoothing (prune-aware page accounting) and the
    # abort guard for optimistically admitted requests that can never fit
    prune_ema: float = 0.5
    max_solo_preemptions: int = 3


@dataclasses.dataclass
class SeqState:
    """One admitted sequence (batch row)."""

    req: object                    # the engine's Request
    base_prompt: List[int]         # the request's original prompt tokens
    tokens: List[int]              # prefill target: base (+ regenerated
    #                                output when resuming after preemption)
    budget: int                    # new tokens still to produce
    slot: int
    admit_seq: int                 # admission order (preemption victim key)
    pages: List[int] = dataclasses.field(default_factory=list)
    kv_len: int = 0                # page slots written
    cur_pos: int = 0               # next original position
    prefilled: int = 0             # prompt tokens processed
    head_votes: Optional[object] = None  # (H, S) bool cross-chunk SPLS
    #                                      column-keep accumulator
    live: Optional[object] = None  # (S,) bool horizon-vote liveness (None
    #                                until the first chunk under a finite
    #                                vote_horizon; see core.planner)

    @property
    def prompt_len(self) -> int:
        return len(self.tokens)

    @property
    def phase(self) -> str:
        return "prefill" if self.prefilled < self.prompt_len else "decode"


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, pool: PagePool,
                 max_len: int, chunkable: bool = True,
                 prune_aware: bool = False, chunk_all: bool = False,
                 telemetry: Optional[Telemetry] = None):
        self.cfg = cfg
        self.pool = pool
        # the engine threads its telemetry in; a bare scheduler gets a
        # disabled one (back-compat counters still work -- they live on
        # the always-on core registry, not behind the knob)
        self.tel = telemetry if telemetry is not None \
            else Telemetry(enabled=False)
        self.max_len = max_len
        # chunked prefill needs causal cross-chunk attention; the engine
        # disables it for non-causal models (SPLS configs now stream their
        # plan chunk by chunk instead of bypassing chunking)
        self.chunkable = chunkable
        # route *every* prefill through the chunk path, including whole
        # prompts (<= one chunk): the packed-compute engine sets this so
        # short prompts get the same token-compacted QKV/FFN execution as
        # long ones instead of silently running the dense full-prefill
        # path (outputs are identical either way -- chunked-vs-full parity
        # is test-pinned -- only the executed FLOPs differ)
        self.chunk_all = chunk_all and chunkable
        # SPLS page pruning: track observed kept/prompt ratios (EMA) so
        # page-need accounting can use a post-prune estimate instead of
        # assuming dense footprints; conservative (dense) fallback until
        # the first observation
        self.prune_aware = prune_aware
        self.prune_ratio: Optional[float] = None
        self.waiting: deque = deque()   # (req, base_prompt, tokens, budget)
        self.slots: List[Optional[SeqState]] = [None] * cfg.n_slots
        self.aborted: List = []         # optimistically admitted, never fit
        self._solo_preempts: dict = {}  # rid -> self-preemption count
        self._admit_seq = 0
        # typed Counter instruments on the telemetry's always-on core
        # registry, behind a dict-shaped live view so legacy
        # `stats["k"] += 1` call sites and test assertions keep working
        self.stats = CounterDictView(self.tel.core, "sched/", _STAT_KEYS)
        # lifetime FLOPs accounting: [dense-equivalent, executed] per
        # component, accumulated over every prefill the engine runs --
        # the measured realization of the paper's Fig. 15 breakdown on
        # the serving path (fed by sparse_compute.accounting.chunk_flops)
        self.flops = {c: [0.0, 0.0] for c in ("qkv", "attn", "ffn")}

    # ------------------------------------------------------------------
    def note_flops(self, comp: dict) -> None:
        """Accumulate one prefill step's (dense, executed) FLOPs per
        component (``{"qkv": (dense, executed), ...}``).  Components not
        seen before (e.g. the standalone ``kv`` share of the
        horizon-finalized K/V packing) are added on first observation."""
        for c, (dense, executed) in comp.items():
            acc = self.flops.setdefault(c, [0.0, 0.0])
            acc[0] += dense
            acc[1] += executed

    def flops_saved_pct(self) -> dict:
        """Lifetime percent of dense-equivalent FLOPs *not* executed,
        per component (0.0 before any prefill ran)."""
        return saved_pct(self.flops)

    def note_prune(self, prompt_len: int, kept: int) -> None:
        """Record an observed post-prune keep ratio (engine calls this
        after every pruned prefill); feeds the admission estimate."""
        if prompt_len <= 0:
            return
        r = kept / prompt_len
        self.prune_ratio = (r if self.prune_ratio is None else
                            (1 - self.cfg.prune_ema) * self.prune_ratio
                            + self.cfg.prune_ema * r)

    def lifetime_pages(self, lp: int, budget: int) -> int:
        """Worst-case pages a request holds at once over its lifetime.

        Dense accounting (``pages_for(lp + budget)``) is the conservative
        fallback.  With pruning observed, the post-prune estimate applies:
        after prefill the sequence holds ``~ratio * lp`` kept slots plus
        its decode growth, while the prefill-time peak is the dense prompt
        (chunked prefill materializes every column until the vote
        finalizes) or the kept count (full prefill allocates post-prune).
        Underestimates are survivable: a request that turns out not to fit
        is aborted by the solo-preemption guard instead of livelocking.
        """
        dense = self.pool.pages_for(min(lp + budget, self.max_len))
        if not self.prune_aware or self.prune_ratio is None:
            return dense
        kept = math.ceil(self.prune_ratio * lp)
        prefill_peak = self.pool.pages_for(
            lp if self.use_chunks(lp) else kept)
        post = self.pool.pages_for(min(kept + budget, self.max_len))
        return min(dense, max(prefill_peak, post))

    def submit(self, req, prompt_tokens: List[int], budget: int) -> None:
        lp = len(prompt_tokens)
        first = (min(lp, self.cfg.prefill_chunk) if self.use_chunks(lp)
                 else lp)
        # both the lifetime footprint and the admission need (first unit of
        # work + watermark) must fit, else the request could never run
        worst = max(self.lifetime_pages(lp, budget),
                    self.pool.pages_for(first) + self.cfg.watermark)
        if worst > self.pool.capacity:
            raise ValueError(
                f"request {req.rid}: needs up to {worst} pages but the pool "
                f"only has {self.pool.capacity}")
        self.waiting.append((req, prompt_tokens, list(prompt_tokens), budget))

    def active(self) -> List[SeqState]:
        return [s for s in self.slots if s is not None]

    def decode_ready(self) -> List[SeqState]:
        return [s for s in self.slots if s is not None
                and s.phase == "decode"]

    def idle(self) -> bool:
        return not self.waiting and not self.active()

    # ------------------------------------------------------------------
    def admit(self) -> List[SeqState]:
        """Fill free slots from the waiting queue while pages allow."""
        admitted = []
        for slot in range(self.cfg.n_slots):
            if self.slots[slot] is not None or not self.waiting:
                continue
            req, base, tokens, budget = self.waiting[0]
            first = (min(len(tokens), self.cfg.prefill_chunk)
                     if self.use_chunks(len(tokens)) else len(tokens))
            need = self.pool.pages_for(first) + self.cfg.watermark
            if need > self.pool.free_pages:
                break  # FIFO: don't let later requests starve the head
            self.waiting.popleft()
            st = SeqState(req=req, base_prompt=base, tokens=tokens,
                          budget=budget, slot=slot,
                          admit_seq=self._admit_seq)
            self._admit_seq += 1
            self.slots[slot] = st
            self.stats["admitted"] += 1
            self.tel.request_admitted(req.rid)
            admitted.append(st)
        return admitted

    def use_chunks(self, prompt_len: int) -> bool:
        return self.chunkable and (prompt_len > self.cfg.prefill_chunk
                                   or self.chunk_all)

    def plan_prefills(self) -> List[SeqState]:
        """Prefill-phase sequences to advance this tick, oldest first."""
        pending = sorted((s for s in self.slots
                          if s is not None and s.phase == "prefill"),
                         key=lambda s: s.admit_seq)
        return pending[:self.cfg.max_prefills_per_tick]

    # ------------------------------------------------------------------
    def grow_to(self, st: SeqState, n_slots_total: int) -> bool:
        """Ensure ``st`` owns pages covering ``n_slots_total`` written
        slots, preempting younger sequences when the pool runs dry.
        Returns False if ``st`` itself had to be preempted (last resort:
        no other sequence holds pages to evict)."""
        while True:
            need = self.pool.pages_for(n_slots_total) - len(st.pages)
            if need <= 0:
                self._solo_preempts.pop(st.req.rid, None)
                return True
            got = self.pool.alloc(need)
            if got is not None:
                st.pages.extend(got)
                self._solo_preempts.pop(st.req.rid, None)
                return True
            victim = self._pick_victim(st)
            if victim is None:
                # nobody else to evict.  Under conservative (dense)
                # admission this is transient; under the optimistic
                # post-prune estimate a request may genuinely never fit --
                # re-prefilling it forever would livelock the engine, so
                # after max_solo_preemptions it is aborted instead (the
                # engine retires it with whatever it generated).
                rid = st.req.rid
                n = self._solo_preempts.get(rid, 0) + 1
                self._solo_preempts[rid] = n
                if n > self.cfg.max_solo_preemptions:
                    self.pool.free(st.pages)
                    st.pages = []
                    self.slots[st.slot] = None
                    self.aborted.append(st.req)
                    self.stats["aborted"] += 1
                    del self._solo_preempts[rid]  # rid may be resubmitted
                    return False
                self.preempt(st)
                return False
            self.preempt(victim)

    def _pick_victim(self, requester: SeqState) -> Optional[SeqState]:
        others = [s for s in self.slots
                  if s is not None and s is not requester and s.pages]
        if not others:
            return None
        return max(others, key=lambda s: s.admit_seq)  # youngest first

    def preempt(self, st: SeqState) -> None:
        """Evict ``st``'s pages and requeue it at the front of the line
        (recompute-style): tokens generated so far fold into the prefill
        target, so greedy decoding resumes the identical continuation
        (exactly -- unless SPLS page pruning re-plans the longer sequence
        differently; see the module docstring)."""
        self.pool.free(st.pages)
        st.pages = []
        self.slots[st.slot] = None
        tokens = list(st.base_prompt) + list(st.req.output)
        budget = st.req.max_new_tokens - len(st.req.output)
        self.waiting.appendleft((st.req, st.base_prompt, tokens, budget))
        self.stats["preemptions"] += 1
        self.tel.request_preempted(st.req.rid)

    def retire(self, st: SeqState) -> None:
        self.pool.free(st.pages)
        st.pages = []
        self.slots[st.slot] = None
        self._solo_preempts.pop(st.req.rid, None)
        self.stats["retired"] += 1
