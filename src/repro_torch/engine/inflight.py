"""Token-level continuous batching: the in-flight decode batch over a
paged, shared-prefix KV cache (port of ``repro/engine/inflight.py``).

Between any two decode steps a newly arrived request is prefilled into a
free slot and rides the remaining steps of the running batch. Each slot
addresses the shared page pool (``core.paging``) through its own page
table. The ``[ctx; query]`` prefix is content-hashed per operator: the
first frame pays the LLM prefill and pins read-only prefix pages, and
every repeat maps the same pages plus fresh private decode pages and skips
the prefill.

Per slot (``vlm.llm_generate``'s convention): the prefix prefill (or a
store hit) emits token 0; each lockstep decode step feeds the slot's last
token at its own position into its own write slot; after ``T`` steps the
final step has read the <SEG> hidden state at the last generated token,
the mask decodes from the frame's SAM features, and the private pages
free. Output is token-exact with ``cloud_generate_batch``.

Admission order is pluggable (``engine.scheduler``): ``FifoScheduler`` by
default; ``QoSScheduler`` adds classes, weighted-fair pops and preemption,
which parks a victim (pages rolled back, tokens carried along) that later
resumes token-exactly by replaying them.

With a ``SpeculativeConfig`` (``spec``) the decoder runs the draft/verify
loop (``engine.speculative``): each step first lets the ``DraftModel``
propose k tokens per speculating row, then scores every row's chunk (its
last accepted token plus the drafts; plain rows a chunk of one) in one
paged multi-token pass, ``cloud_verify_rows``. Rows advance by 1..k+1
tokens a step; decode pages are allocated ahead for the draft overhang and
roll back past the accepted length (``PagePool.grow_to``/``rollback_to``).
Output stays token-exact with the plain path: a draft is kept only where
it equals the serving model's own greedy pick.

With a ``MetricsRegistry`` and a ``wallclock`` the decoder times each
decode and verify step into the registry's histograms. The stage profiler
and the cost ledger are not ported yet (ROADMAP.md, Queue 1 item 4b):
passing either raises.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import packets as pk
from repro_torch.core.intent import Intent
from repro_torch.core.paging import (TRASH_PAGE, PagePool, pages_for,
                                     prefix_digest, prefix_positions)
from repro_torch.engine.faults import CloudStageError
from repro_torch.engine.observability import Tracer
from repro_torch.engine.scheduler import FifoScheduler
from repro_torch.engine.speculative import (DraftModel, SpecStats,
                                            SpeculativeConfig, greedy_accept)

_ROADMAP = "is not ported yet; see ROADMAP.md, Queue 1"


@dataclass
class _PendingRequest:
    seq_id: int
    intent: Intent
    packet: pk.Packet
    query: np.ndarray
    on_done: Callable[[Dict[str, Any]], None]
    operator_id: str = ""
    speculative: Optional[bool] = None   # None -> decoder default
    # scheduling state (see engine.scheduler)
    priority: int = 0                 # strict band; higher admits first
    deadline: Optional[float] = None  # mission-clock expiry
    t_enqueue: float = 0.0            # when this wait segment started
    queue_wait: float = 0.0           # total time queued (all segments)
    resumes: int = 0                  # times parked by preemption
    resume_tokens: Optional[List[int]] = None  # generated-so-far tokens
    t_first_token: Optional[float] = None  # first admission (TTFT anchor)


@dataclass
class _SlotState:
    req: _PendingRequest
    tokens: List[int]                 # greedy answer tokens so far
    logits0: np.ndarray               # (1, V) first-token logits
    feats: Optional[Any]              # (1, T_sam, d_sam) or None (context)
    pos: int                          # absolute position of the next token
    joined_step: int                  # global step index at admission
    prefix_ids: Tuple[int, ...]       # shared prefix pages (one ref held)
    private_ids: List[int]            # this slot's decode pages
    prefix_hit: bool
    speculative: bool = False         # drafting enabled for this row
    seg: Optional[np.ndarray] = None  # <SEG> state once the final token fed
    steps_done: int = 0
    batch_acc: int = 0                # sum of co-active slots over steps
    replay: Optional[Deque[int]] = None  # parked tokens to re-decode
    t_admit: float = 0.0              # this residency segment's start


class InflightDecoder:
    """Drives the executor's paged in-flight stages over a fixed slot
    layout.

    One decoder serves one query length (the prefill shape). ``submit``
    admits into a free slot immediately (prefix lookup/prefill + page
    allocation); ``step`` advances every live slot one token; ``drain``
    runs admission + steps until no work remains.
    """

    def __init__(self, executor, slots: int = 8,
                 pool: Optional[PagePool] = None,
                 spec: Optional[SpeculativeConfig] = None,
                 spec_gate: Optional[Callable[[SpecStats], bool]] = None,
                 spec_prefix_rows: Optional[Dict[Any, Any]] = None,
                 scheduler: Optional[Any] = None,
                 clock: Optional[Callable[[], float]] = None,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[Any] = None,
                 wallclock: Optional[Callable[[], float]] = None,
                 profiler: Optional[Any] = None,
                 cost: Optional[Any] = None):
        """``metrics`` (a ``MetricsRegistry``) and ``wallclock`` (a wall
        time source such as ``time.perf_counter``; this module never reads
        the wall clock itself) fill the ``decode_step_s`` and
        ``verify_step_s`` histograms with the wall time of each
        ``cloud_decode_rows`` / ``cloud_verify_rows`` call. Those calls end
        in a copy of their logits to the host, so on the card the time
        includes the step's device work."""
        for name, value in (("the stage profiler (profiler)", profiler),
                            ("the cost ledger (cost)", cost)):
            if value is not None:
                raise NotImplementedError(f"{name} {_ROADMAP}")
        self.executor = executor
        # observability: the engine threads its tracer/registry through; a
        # standalone decoder records nothing
        self.tracer = tracer if tracer is not None else Tracer()
        self._metrics = metrics
        self._wallclock = wallclock
        self.scheduler = scheduler if scheduler is not None \
            else FifoScheduler()
        self._clock = clock or (lambda: 0.0)
        self.slots = int(slots)
        self.T = int(executor.max_new_tokens)
        self.pool = pool if pool is not None else PagePool(
            page_size=executor.page_size)
        if self.pool.page_size != executor.page_size:
            raise ValueError(
                f"pool page_size {self.pool.page_size} != executor "
                f"page_size {executor.page_size}")
        # speculative decoding: config + the policy's drafting gate; the
        # DraftModel is built lazily once the prefix geometry is known
        self.spec = spec
        self.spec_gate = spec_gate or (lambda stats: True)
        self.spec_stats = SpecStats()
        # draft prefill rows shared across decoders (None -> private)
        self.spec_prefix_rows = spec_prefix_rows
        self.draft: Optional[DraftModel] = None
        self.active: Dict[int, _SlotState] = {}
        self.qlen: Optional[int] = None
        # per-slot paging state, shaped once qlen is known
        self.page_tables: Optional[np.ndarray] = None   # (slots, n_pages)
        self.positions: Optional[np.ndarray] = None     # (slots, W_virtual)
        self.step_idx = 0                 # global decode-step counter
        self.n_steps = 0
        self.n_slot_steps = 0             # sum of live slots across steps
        self.n_served = 0
        self.n_cancelled = 0              # requests removed via cancel()
        self.n_stage_faults = 0           # CloudStageErrors absorbed
        self.n_preempted = 0              # rows parked for urgent work
        self.n_rejected = 0               # shed at enqueue (queue bound)
        self.n_expired = 0                # dead on arrival at admission
        self._admitting = False           # reentrancy guard (see admit)

    @property
    def pending(self):
        """View of queued admissions: the FIFO scheduler's real deque, or
        a read-only snapshot across a QoS scheduler's class queues."""
        q = getattr(self.scheduler, "queue", None)
        return q if q is not None else self.scheduler.snapshot()

    # ---- geometry (fixed once qlen is known) ----

    @property
    def prefix_len(self) -> int:
        return self.executor.pcfg.clip_tokens + self.qlen

    @property
    def n_prefix_pages(self) -> int:
        return pages_for(self.prefix_len, self.pool.page_size)

    @property
    def n_private_pages(self) -> int:
        return pages_for(self.T, self.pool.page_size)

    @property
    def width(self) -> int:
        """Virtual sequence width of one row (page-padded)."""
        return (self.n_prefix_pages + self.n_private_pages) \
            * self.pool.page_size

    @property
    def has_work(self) -> bool:
        return bool(self.scheduler.has_pending or self.active)

    # ---- queueing ----

    def submit(self, seq_id: int, intent: Intent, packet: pk.Packet, query,
               on_done: Callable[[Dict[str, Any]], None],
               operator_id: str = "",
               speculative: Optional[bool] = None,
               priority: int = 0,
               deadline: Optional[float] = None,
               t_submit: Optional[float] = None) -> None:
        """``speculative``: per-request drafting override. None follows
        the decoder (drafting iff it has a ``SpeculativeConfig``); False
        keeps the row plain on a speculating decoder (plain and
        speculating rows share the verify batch).

        ``priority``/``deadline``/``t_submit`` feed the scheduler:
        strict band, mission-clock expiry (expired items resolve
        ``failure="deadline"`` before paying a prefill), and the enqueue
        timestamp. A bounded scheduler may shed the request here:
        ``on_done`` then fires at once with ``failure="rejected"``."""
        query = np.asarray(query).reshape(-1, np.asarray(query).shape[-1])
        if query.shape[0] != 1:
            raise ValueError(
                "in-flight slots hold one sequence each; split "
                f"{query.shape[0]}-row packets at the edge")
        if self.qlen is None:
            self.qlen = int(query.shape[-1])
        elif int(query.shape[-1]) != self.qlen:
            raise ValueError(
                f"decoder serves qlen={self.qlen}, got {query.shape[-1]}")
        now = self._clock()
        item = _PendingRequest(seq_id, intent, packet, query, on_done,
                               operator_id, speculative=speculative,
                               priority=int(priority),
                               deadline=deadline,
                               t_enqueue=t_submit if t_submit is not None
                               else now)
        reason = self.scheduler.enqueue(item, now)
        if reason is not None:
            self.n_rejected += 1
            item.on_done({
                "seq_id": item.seq_id, "intent": item.intent,
                "tier_name": item.packet.tier_name,
                "failure": "rejected", "reason": reason})
            return
        self.admit()

    # ---- admission: prefix reuse + page allocation between steps ----

    @staticmethod
    def _prefix_ctx(packet: pk.Packet) -> np.ndarray:
        """The context features feeding the LLM prefix: the CLIP stream
        riding in either packet kind."""
        return packet.content["clip" if packet.kind == "insight" else "ctx"]

    def admit(self) -> int:
        """Admit queued requests into free slots in scheduler order, then
        let urgent queued work preempt. A ``CloudStageError`` from an
        admission stage fails only that request. Reentrant calls (an
        ``on_done`` callback resubmitting mid-admission) are no-ops; the
        outer loop picks up whatever they queued."""
        if self._admitting:
            return 0
        self._admitting = True
        try:
            admitted = 0
            now = self._clock()
            while self.scheduler.has_pending \
                    and len(self.active) < self.slots:
                item = self.scheduler.pop_next(now)
                if item is None:
                    break
                admitted += self._try_admit(item, now)
            # preemption: an urgent pending request evicts the lowest-
            # ranked active decode, which parks token-exactly and requeues
            # at the front of its class. Bounded by ``slots``: each round
            # parks one strictly lower-ranked victim.
            for _ in range(self.slots):
                if not (self.scheduler.has_pending and self.active):
                    break
                pick = self.scheduler.pick_preemption(self.active, now)
                if pick is None:
                    break
                item, victim = pick
                self._park_slot(victim, self.active[victim])
                admitted += self._try_admit(item, now)
            return admitted
        finally:
            self._admitting = False

    def _try_admit(self, item: _PendingRequest, now: float) -> int:
        """Admit one popped item. An already-expired deadline resolves
        ``failure="deadline"`` here, before the prefill."""
        if item.deadline is not None and now >= item.deadline:
            self.n_expired += 1
            self.scheduler.note_expired()
            item.on_done({
                "seq_id": item.seq_id, "intent": item.intent,
                "tier_name": item.packet.tier_name,
                "failure": "deadline"})
            return 0
        try:
            slot, st = self._admit_one(item)
            self.scheduler.note_admitted(item, now)
            st.t_admit = now
            if item.t_first_token is None:
                item.t_first_token = now   # token 0 exists from here on
            if self.tracer.enabled:
                rid = item.seq_id
                self.tracer.span(rid, "queue", item.t_enqueue,
                                 max(now, item.t_enqueue))
                if item.resumes and item.resume_tokens is not None:
                    self.tracer.point(rid, "resume", now, slot=slot,
                                      replayed=len(item.resume_tokens))
                self.tracer.span(
                    rid, "prefix_hit" if st.prefix_hit else "prefill",
                    now, now, slot=slot)
            return 1
        except CloudStageError as e:
            self.n_stage_faults += 1
            item.on_done({
                "seq_id": item.seq_id, "intent": item.intent,
                "tier_name": item.packet.tier_name,
                "failure": "cloud_error", "error": str(e)})
            return 0

    def _admit_one(self, item: _PendingRequest
                   ) -> Tuple[int, _SlotState]:
        """Prefill one request into a free slot; returns the slot and its
        state. A stage failure unwinds exactly the pages acquired so far
        and re-raises, so a fault mid-admission never leaks a page or
        leaves a half-written prefix in the store."""
        page = self.pool.page_size
        ctx = self._prefix_ctx(item.packet)
        key = (item.operator_id, prefix_digest(ctx, item.query))
        entry = self.pool.lookup_prefix(key)
        hit = entry is not None
        if not hit:
            logits0, paged = self.executor.cloud_prefix(ctx, item.query)
            self.pool.ensure(
                self.n_prefix_pages, like=paged,
                capacity_hint=1 + self.slots * (self.n_prefix_pages
                                                + self.n_private_pages))
            ids = self.pool.alloc(self.n_prefix_pages)
            try:
                self.pool.kv = self.executor.pool_write(self.pool.kv, paged,
                                                        ids)
            except Exception:
                self.pool.release(ids)
                raise
            entry = self.pool.put_prefix(key, ids, self.prefix_len, logits0)
        else:
            # a hit rides the stored pages: take this request's ref (a
            # miss already owns its pages' alloc reference)
            self.pool.retain(entry.page_ids)
        # SAM feats before decode-page allocation: a feats fault unwinds by
        # dropping this request's prefix ref alone
        try:
            feats = (self.executor.cloud_sam_feats(item.packet)
                     if item.packet.kind == "insight" else None)
        except Exception:
            self.pool.release(entry.page_ids)
            raise
        speculative = (self.spec is not None
                       and item.speculative is not False)
        # speculating rows allocate decode pages lazily per verify chunk
        # (grown ahead of acceptance, rolled back on rejection); plain rows
        # take the whole answer's pages up front
        private = ([] if speculative
                   else self.pool.alloc(self.n_private_pages))
        slot = min(set(range(self.slots)) - set(self.active))
        if self.page_tables is None:
            n_pages = self.n_prefix_pages + self.n_private_pages
            self.page_tables = np.full((self.slots, n_pages),
                                       TRASH_PAGE, np.int32)
            self.positions = np.full((self.slots, self.width), -1,
                                     np.int32)
        self.page_tables[slot] = (list(entry.page_ids) + private
                                  + [TRASH_PAGE] * (self.n_private_pages
                                                    - len(private)))
        self.positions[slot] = -1
        self.positions[slot, :self.n_prefix_pages * page] = \
            prefix_positions(self.prefix_len, self.n_prefix_pages, page)
        if speculative:
            if self.draft is None:
                self.draft = self._make_draft()
            # the serving prefix store's key: repeat-prefix frames skip the
            # draft prefill too (honouring the pool's sharing knob)
            self.draft.admit(slot, ctx, item.query,
                             key=key if self.pool.share_prefixes else None)
        st = _SlotState(
            req=item, tokens=[int(np.argmax(entry.logits0[0]))],
            logits0=entry.logits0, feats=feats, pos=self.prefix_len,
            joined_step=self.step_idx, prefix_ids=entry.page_ids,
            private_ids=private, prefix_hit=hit, speculative=speculative)
        if item.resume_tokens:
            # a parked victim resumes from its prefix: token 0 re-emerges
            # from the prefix logits, the rest replay through the decode
            # loop. Greedy decoding makes the replay identical to the
            # original run, so the resumed request stays token-exact.
            st.replay = deque(item.resume_tokens[1:])
        self.active[slot] = st
        return slot, st

    # ---- cancellation (deadline enforcement) ----

    def cancel(self, seq_id: int) -> bool:
        """Remove one request from the decoder, pending or mid-decode,
        releasing its slot and pages refcount-safely. Returns False when
        ``seq_id`` is not here."""
        if self.scheduler.remove(seq_id):
            self.n_cancelled += 1
            return True
        for s, st in list(self.active.items()):
            if st.req.seq_id == seq_id:
                self._release_slot(s, st)
                self.n_cancelled += 1
                self.admit()          # the freed slot lets queued work in
                return True
        return False

    def _make_draft(self) -> DraftModel:
        cfg = self.spec
        return DraftModel(
            cfg.draft_params or self.executor.params,
            cfg.draft_pcfg or self.executor.pcfg,
            slots=self.slots, prefix_len=self.prefix_len,
            max_new_tokens=self.T, draft_tokens=cfg.draft_tokens,
            flash_decode=getattr(self.executor, "flash_decode", False),
            prefix_rows=self.spec_prefix_rows,
            prefix_cap=self.pool.max_prefixes,
            fns_factory=getattr(self.executor, "draft_fns", None),
            device=self.executor.device)

    # ---- the lockstep decode step ----

    def step(self) -> int:
        """Advance every live slot (no-op when idle); returns the number
        of requests that finished on this step. Plain rows advance one
        token; speculating rows advance by however many drafted tokens the
        serving model accepts (1..k+1), sharing one verify batch."""
        if not self.active:
            return 0
        draft_rows = {}
        if self.spec is not None and self.draft is not None:
            # resumed rows replay their parked tokens through the plain
            # path first; they rejoin drafting once the replay drains
            candidates = {s: st for s, st in self.active.items()
                          if st.speculative and len(st.tokens) < self.T
                          and not st.replay}
            if candidates and self.spec_gate(self.spec_stats):
                draft_rows = candidates
            elif candidates:
                self.spec_stats.disabled_steps += 1
        if draft_rows:
            return self._step_verify(draft_rows)
        return self._step_plain()

    def _step_plain(self) -> int:
        """One single-token decode step over all live rows (also serves
        speculating rows whose drafting the policy vetoed, and rows that
        only need their final <SEG> read)."""
        base = self.n_prefix_pages * self.pool.page_size
        toks = np.zeros((self.slots, 1), np.int32)
        # free rows decode garbage through the trash page (their page
        # tables were reset on release); outputs are discarded
        pos = np.zeros((self.slots,), np.int32)
        write_slot = np.zeros((self.slots,), np.int32)
        for s, st in self.active.items():
            # speculating rows manage decode pages lazily: cover the slot
            # being written (a no-op for plain rows)
            self._grow_private(s, st, len(st.tokens))
            toks[s, 0] = st.tokens[-1]
            pos[s] = st.pos
            write_slot[s] = base + len(st.tokens) - 1
        wc = self._wallclock
        w0 = wc() if wc is not None else 0.0
        try:
            logits, seg, self.pool.kv = self.executor.cloud_decode_rows(
                self.pool.kv, self.page_tables, self.positions, toks, pos,
                write_slot)
        except CloudStageError as e:
            return self._fail_step(e)
        if wc is not None and self._metrics is not None:
            self._metrics.histogram("decode_step_s").observe(wc() - w0)
        live = len(self.active)
        self.n_steps += 1
        self.n_slot_steps += live
        now = self._clock()
        finished = 0
        for s, st in list(self.active.items()):
            n = len(st.tokens)
            self.positions[s, base + n - 1] = st.pos
            st.steps_done += 1
            st.batch_acc += live
            if self.tracer.enabled:
                self.tracer.point(st.req.seq_id, "decode_step", now,
                                  slot=s, step=self.step_idx)
            if n < self.T:
                if st.replay:
                    # replaying a parked run: the stored token IS the
                    # greedy pick, so feeding it keeps the row token-exact
                    st.tokens.append(st.replay.popleft())
                    self.scheduler.note_replayed()
                else:
                    st.tokens.append(int(np.argmax(logits[s])))
                st.pos += 1
                continue
            # final step: this row's seg is the <SEG> state at the last
            # generated token (llm_generate's convention for every T)
            st.seg = seg[s]
            finished += self._finish_slot(s, st)
        self.step_idx += 1
        if finished:
            self.admit()              # freed slots let queued requests in
        return finished

    def _step_verify(self, draft_rows: Dict[int, _SlotState]) -> int:
        """One speculative verify step: drafting rows carry their last
        accepted token plus k drafts, every other live row a chunk of one;
        a single paged multi-token pass scores them all, greedy acceptance
        advances each row, and decode pages past each row's accepted
        length roll back."""
        k = self.spec.draft_tokens
        C = k + 1
        base = self.n_prefix_pages * self.pool.page_size
        proposals = self.draft.draft(
            {s: st.tokens for s, st in draft_rows.items()}, k,
            budgets={s: self.T - len(st.tokens)
                     for s, st in draft_rows.items()})
        toks = np.zeros((self.slots, C), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        write_slot = np.zeros((self.slots,), np.int32)
        clens = np.ones((self.slots,), np.int32)
        n_drafted: Dict[int, int] = {}
        for s, st in self.active.items():
            n = len(st.tokens)
            toks[s, 0] = st.tokens[-1]
            pos[s] = st.pos
            write_slot[s] = base + n - 1
            if s in proposals:
                j = min(k, self.T - n)        # never draft past the answer
                n_drafted[s] = j
                toks[s, 1:1 + j] = proposals[s][:j]
                clens[s] = 1 + j
            # cover the chunk (the draft overhang too) with decode pages
            self._grow_private(s, st, n - 1 + int(clens[s]))
        wc = self._wallclock
        w0 = wc() if wc is not None else 0.0
        try:
            logits, seg, self.pool.kv = self.executor.cloud_verify_rows(
                self.pool.kv, self.page_tables, self.positions, toks, pos,
                write_slot, clens)
        except CloudStageError as e:
            return self._fail_step(e)
        if wc is not None and self._metrics is not None:
            self._metrics.histogram("verify_step_s").observe(wc() - w0)
        live = len(self.active)
        self.n_steps += 1
        self.n_slot_steps += live
        now = self._clock()
        finished = 0
        for s, st in list(self.active.items()):
            n = len(st.tokens)
            j = n_drafted.get(s, 0)
            # greedy[i]: the serving model's own pick after chunk token i
            greedy = np.argmax(logits[s, :1 + j], axis=-1)
            m = greedy_accept(toks[s, 1:1 + j], greedy) if j else 0
            # chunk tokens 0..m are now committed: the real last token
            # plus m accepted drafts
            for i in range(m + 1):
                self.positions[s, base + n - 1 + i] = st.pos + i
            new = [int(g) for g in greedy[:m + 1]][:self.T - n]
            st.tokens.extend(new)
            st.pos += len(new)
            if st.replay:
                # a resumed row riding someone else's verify batch advances
                # by the model's own greedy picks, identical to the parked
                # tokens, so its replay drains in step
                for _ in new:
                    if st.replay:
                        st.replay.popleft()
                        self.scheduler.note_replayed()
            st.steps_done += 1
            st.batch_acc += live
            if self.tracer.enabled:
                self.tracer.point(st.req.seq_id, "verify_step", now,
                                  slot=s, step=self.step_idx,
                                  drafted=j, accepted=int(m))
            if j:
                # accepted drafts the draft model fed itself (d_1..d_{j-1};
                # the j-th came off the last feed's logits) already sit in
                # its cache at their committed positions
                self.draft.commit(s, n + min(m, j - 1))
                self.spec_stats.note_chunk(j, m, len(new),
                                           metrics=self._metrics)
                # rollback: free decode pages past the accepted length
                dropped = self.pool.rollback_to(st.private_ids, n + m)
                if dropped:
                    self.spec_stats.pages_rolled_back += len(dropped)
                    lo = self.n_prefix_pages + len(st.private_ids)
                    self.page_tables[s, lo:lo + len(dropped)] = TRASH_PAGE
            if n - 1 + m >= self.T - 1:
                # the answer's final token was fed and accepted in this
                # chunk: its hidden state is the <SEG> read
                st.seg = seg[s, self.T - n]
                finished += self._finish_slot(s, st)
        self.step_idx += 1
        if finished:
            self.admit()
        return finished

    def _grow_private(self, slot: int, st: _SlotState, tokens: int) -> None:
        """Extend one row's private decode pages to cover ``tokens``
        virtual slots (for speculating rows, ahead of acceptance) and map
        the fresh pages into its page table (a no-op for plain rows, whose
        pages were allocated at admission)."""
        lo = self.n_prefix_pages + len(st.private_ids)
        fresh = self.pool.grow_to(st.private_ids, tokens)
        if fresh:
            self.page_tables[slot, lo:lo + len(fresh)] = fresh

    def _fail_step(self, err: CloudStageError) -> int:
        """A batch-wide decode stage died: the step failed for every live
        row. Release all slots first, then report each request as a
        ``cloud_error`` (callbacks may resubmit into the now-free slots),
        then admit queued work."""
        self.n_stage_faults += 1
        failed = list(self.active.items())
        for s, st in failed:
            self._release_slot(s, st)
        for _, st in failed:
            st.req.on_done({
                "seq_id": st.req.seq_id, "intent": st.req.intent,
                "tier_name": st.req.packet.tier_name,
                "failure": "cloud_error", "error": str(err)})
        self.admit()
        return 0

    def _finish_slot(self, s: int, st: _SlotState) -> int:
        """Deliver a finished row: decode its mask from the stored SAM
        feats and the captured <SEG> state, hand the result back, and
        release its pages."""
        if self.tracer.enabled:
            now = self._clock()
            self.tracer.span(st.req.seq_id, "decode", st.t_admit,
                             max(now, st.t_admit), slot=s,
                             tokens=len(st.tokens))
        mask = None
        if st.feats is not None:
            try:
                mask = self.executor.cloud_mask(st.feats, st.seg[None])
            except CloudStageError as e:
                self.n_stage_faults += 1
                self._release_slot(s, st)
                st.req.on_done({
                    "seq_id": st.req.seq_id, "intent": st.req.intent,
                    "tier_name": st.req.packet.tier_name,
                    "failure": "cloud_error", "error": str(e)})
                return 1
        st.req.on_done({
            "seq_id": st.req.seq_id,
            "intent": st.req.intent,
            "tier_name": st.req.packet.tier_name,
            "answer_logits": st.logits0,
            "mask_logits": mask,
            "tokens": np.asarray(st.tokens, np.int32)[None, :],
            "batch_size": st.batch_acc / max(1, st.steps_done),
            "joined_step": st.joined_step,
            "prefix_hit": st.prefix_hit,
            "speculative": st.speculative,
            "preemptions": st.req.resumes,
            "queue_wait": st.req.queue_wait,
            "t_first_token": st.req.t_first_token,
        })
        if st.req.resumes:
            self.scheduler.note_resumed_served()
        self._release_slot(s, st)
        self.n_served += 1
        return 1

    def _release_slot(self, slot: int, st: _SlotState) -> None:
        """Return the slot's pages (prefix ref + private pages) and park
        its row on the trash page so later steps can't touch live KV."""
        self.pool.release(st.prefix_ids)
        self.pool.release(st.private_ids)
        self.page_tables[slot] = TRASH_PAGE
        self.positions[slot] = -1
        if st.speculative and self.draft is not None:
            self.draft.release(slot)
        del self.active[slot]

    def _park_slot(self, slot: int, st: _SlotState) -> None:
        """Preempt one active decode: roll its private pages back to empty
        (``PagePool.rollback_to``), drop its prefix reference, and requeue
        the request at the front of its class carrying its generated-so-
        far tokens. Re-admission replays them from the (usually still
        cached) prefix, token-exactly."""
        if self.tracer.enabled:
            now = self._clock()
            self.tracer.span(st.req.seq_id, "decode", st.t_admit,
                             max(now, st.t_admit), slot=slot,
                             tokens=len(st.tokens))
            self.tracer.point(st.req.seq_id, "park", now, slot=slot)
        self.pool.rollback_to(st.private_ids, 0)
        self.pool.release(st.prefix_ids)
        self.page_tables[slot] = TRASH_PAGE
        self.positions[slot] = -1
        if st.speculative and self.draft is not None:
            self.draft.release(slot)
        del self.active[slot]
        item = st.req
        item.resume_tokens = list(st.tokens)
        item.resumes += 1
        item.t_enqueue = self._clock()
        self.n_preempted += 1
        self.scheduler.note_preempted()
        self.scheduler.requeue_preempted(item, item.t_enqueue)

    def pump(self, max_steps: int = 1) -> None:
        # admission first: pending requests must start even when no batch
        # is running
        self.admit()
        for _ in range(max_steps):
            if not self.active:
                break
            self.step()

    def drain(self) -> None:
        self.admit()
        while self.active:
            self.step()

    @property
    def mean_live_slots(self) -> float:
        return self.n_slot_steps / max(1, self.n_steps)
