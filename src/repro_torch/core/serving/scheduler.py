"""Token-budget continuous-batching scheduler over the paged SVA layer.

Every engine step the scheduler composes ONE mixed batch: all decoding
sequences contribute their next token, and remaining budget is spent on
chunked-prefill slices of sequences still computing their prompt KV
(vLLM/eSurge-style continuous batching). The composition is driven by two
knobs (``ModelConfig.sched_*``):

  token_budget    target tokens processed per step (decodes count 1 each;
                  chunks consume the rest — decodes are never dropped, so
                  a step with more decoding sequences than budget still
                  decodes them all in the one batched call)
  prefill_chunk   per-sequence cap on prompt tokens prefilled per step

Chunk spans are PAGE-ALIGNED at non-final boundaries: the suffix-prefill
scatter writes whole pages, and the next chunk's prefix-read then never
straddles a half-written page. The final chunk ends exactly at the prompt
length and produces the sequence's first token.

Admission is LAZY (``PagedKVManager.admit(lazy=True)``): only the prompt's
pages are allocated up front; decode growth allocates page-by-page. That
admits more concurrent sequences than the fixed-slot engine's full
``prompt+max_tokens`` reservation — the continuous engine's throughput win
— at the cost of possible pool exhaustion mid-decode, which preemption
resolves:

  preempt   when the next step's page demand (decode appends crossing page
            boundaries, CoW divergences) exceeds the pool's headroom (free
            pages + evictable warm prefix-cache pages), the NEWEST-admitted
            running sequence is preempted: its computed KV is registered in
            the prefix index (warm pages an immediate resume re-matches),
            its slot/pages/ASID are torn down exactly like a release, and
            its known tokens go back to the FRONT of the waiting queue.
  resume    re-admission of a preempted sequence: the prompt becomes every
            KV-resident token it had (original prompt + generated tokens
            minus the one pending token), ``max_tokens`` is rebased so the
            generation budget is unchanged, and the pending token is
            re-injected by the final chunk instead of an argmax — so a
            preempt/resume round-trip is bit-identical to never having
            been preempted, whether the KV re-matches warm pages or is
            recomputed from tokens. Re-admission goes through the same
            ``PagedKVManager.admit`` path as a fresh sequence, so its
            fresh pages are re-allocated with the contiguity hint
            (``PagePool.alloc_run``) — a resumed sequence re-tries
            contiguous placement and stays eligible for range-coalesced
            IOTLB entries even after its original run was torn down.

The scheduler mutates manager state (admit/preempt/resume) and the
:class:`~repro_torch.core.serving.sequence_buffer.SequenceBuffer`, and returns a
:class:`SchedulerOutput` that drives the engine's device step. Page-pool
verbs stay inside the manager (svalint R002); translation-trace events
(``preempt``/``resume``/``map``/``unmap``) are emitted through ``on_event``
so the engine's recorded trace stays replayable across preemptions.

Same-step sharing note: under chunked prefill the prefix index is fed
PROGRESSIVELY (pages register as their chunks complete — see
``PagedKVManager.register_progress``), so an admission can only match KV
that is actually resident. Two identical prompts admitted in the SAME
schedule() call therefore do not share (the fixed engine's admission waves
would); they share from the next step on.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.core.serving.sequence_buffer import SequenceBuffer
from repro_torch.core.sva.kv_manager import PagedKVManager


@dataclass
class WaitingSeq:
    """One queued (or preempted-awaiting-resume) sequence."""
    seq_id: int
    tokens: List[int]             # prompt; for a preempted decoding seq,
                                  # every KV-resident token (prompt + gen[:-1])
    max_tokens: int               # remaining generation budget (rebased)
    pending: Optional[int] = None  # decode token to re-inject on resume
    preempted: bool = False
    tenant: Optional[str] = None   # owning TenantDomain (None = untenanted)


@dataclass
class ChunkSpan:
    """One chunked-prefill slice: prompt positions ``[start, end)`` of the
    sequence in ``slot``. ``pending`` (final chunks of resumed sequences
    only) replaces the argmax first token."""
    seq_id: int
    slot: int
    start: int
    end: int
    is_final: bool
    pending: Optional[int] = None


@dataclass
class SchedulerOutput:
    """What one step runs — scheduled ids, chunk spans, preempted/resumed
    ids — consumed by ``ServingEngine._continuous_step``."""
    decode_slots: List[int] = field(default_factory=list)
    chunks: List[ChunkSpan] = field(default_factory=list)
    admitted: List[int] = field(default_factory=list)
    resumed: List[int] = field(default_factory=list)
    # (seq_id, generated tokens folded into the resume prompt) — the engine
    # moves the folded tokens to Request.out_tokens at preemption time
    preempted: List[Tuple[int, List[int]]] = field(default_factory=list)
    n_decode_tokens: int = 0
    n_chunk_tokens: int = 0


class Scheduler:
    """Token-budget step composer (see module docstring)."""

    def __init__(self, mgr: PagedKVManager, buffer: SequenceBuffer,
                 token_budget: int, prefill_chunk: int,
                 share_tokens: bool = True,
                 on_event: Optional[Callable[[tuple], None]] = None):
        if token_budget < 1:
            raise ValueError(f"token_budget={token_budget} (need >= 1)")
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk={prefill_chunk} (need >= 1)")
        self.mgr = mgr
        self.buffer = buffer
        self.token_budget = token_budget
        self.prefill_chunk = prefill_chunk
        self.share_tokens = share_tokens
        self.on_event = on_event
        self.waiting: Deque[WaitingSeq] = deque()
        self.running: List[int] = []          # admission order = priority
        self._pending_tok: Dict[int, Optional[int]] = {}
        # Preemption floor: the colocated scheduler never preempts its
        # oldest running sequence (IT is the forward progress). A
        # disaggregated prefill worker lowers this to 0 — there the decode
        # worker carries forward progress, and under pool pressure every
        # prefill must be able to yield its pages to decode growth.
        self.min_running = 1
        self.preemptions = 0
        self.resumes = 0

    # ----------------------------------------------------------------- API
    def submit(self, seq_id: int, prompt: List[int], max_tokens: int,
               tenant: Optional[str] = None) -> None:
        if not prompt:
            raise ValueError("continuous scheduling needs a non-empty prompt")
        # reject-never-wrap; with a tenant this also rejects requests that
        # can never fit the tenant's page quota
        self.mgr.ensure_fits(len(prompt), max_tokens, tenant=tenant)
        self.waiting.append(WaitingSeq(seq_id, list(prompt), max_tokens,
                                       tenant=tenant))

    def finish(self, seq_id: int) -> None:
        """A sequence completed (the engine releases it): drop scheduler +
        buffer state. Called BEFORE ``PagedKVManager.release``."""
        self.running.remove(seq_id)
        self._pending_tok.pop(seq_id, None)
        self.buffer.detach(self.buffer.slot_of(seq_id))

    def handoff(self, seq_id: int) -> None:
        """Forget a sequence WITHOUT touching manager or buffer state — the
        disaggregated front-end migrates its KV to a decode worker and
        re-attaches the buffer row itself. The sequence simply stops being
        this scheduler's to run."""
        self.running.remove(seq_id)
        self._pending_tok.pop(seq_id, None)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ------------------------------------------------------------ schedule
    def schedule(self) -> SchedulerOutput:
        out = SchedulerOutput()
        # 1. Guarantee the step's page demand: every decoding sequence
        #    appends one token (possible page growth / CoW allocation).
        #    Preempt newest-first until the pool (after prefix-cache
        #    eviction) can satisfy it; the oldest running sequence is never
        #    preempted (guaranteed forward progress).
        while (len(self.running) > self.min_running
               and self.mgr.next_step_page_demand()
               > self.mgr.free_page_headroom()):
            out.preempted.append(self._preempt_one())
        # 1b. Quota pressure (multi-tenant only): decode appends are never
        #     blocked on a quota — a mid-step allocation can't wait — so a
        #     tenant can drift over its page quota through decode growth
        #     and CoW. Shed the over-quota tenant's NEWEST sequences until
        #     it is back under, always sparing its oldest running sequence
        #     (whose completions are what drain the debt; preempting the
        #     last one would just thrash preempt/resume).
        if self.mgr.tenant_specs:
            for t in self.mgr.tenants_over_quota():
                mine = [sid for sid in self.running
                        if self.mgr.seqs[sid].tenant == t]
                for sid in reversed(mine[1:]):
                    if (len(self.running) <= self.min_running
                            or self.mgr.tenant_pages_used(t)
                            <= self.mgr.tenant_quota(t)):
                        break
                    out.preempted.append(self._preempt_sid(sid))
        # 2. Resume/admit from the waiting queue (preempted sequences sit at
        #    the front). Don't admit into the headroom the running
        #    sequences' growth needs — that admission would be preempted
        #    right back next step. With tenants, quota-blocked entries are
        #    skipped (not head-of-line blocking the other tenants) — FIFO
        #    order is preserved among the eligible.
        while self.waiting:
            idx = 0
            if self.mgr.tenant_specs:
                idx = next((i for i, w in enumerate(self.waiting)
                            if not self._quota_blocked(w)), -1)
                if idx < 0:
                    break       # everyone waiting is over quota: wait
            ws = self.waiting[idx]
            need = -(-len(ws.tokens) // self.mgr.page_size)
            if len(ws.tokens) % self.mgr.page_size == 0:
                # The final chunk's first-token append lands one past the
                # prompt: when the prompt exactly fills its pages that
                # append allocates ANOTHER page the ceil above misses —
                # admitting against it drains the pool mid-step (decode
                # appends can't wait; they'd hit OutOfPages).
                need += 1
            if (self.running
                    and self.mgr.free_page_headroom() - need
                    < self.mgr.next_step_page_demand()):
                break
            if ws.preempted:
                st = self.mgr.resume(
                    ws.seq_id, len(ws.tokens), ws.max_tokens,
                    tokens=ws.tokens if self.share_tokens else None,
                    tenant=ws.tenant)
            else:
                st = self.mgr.admit(
                    ws.seq_id, len(ws.tokens), ws.max_tokens,
                    tokens=ws.tokens if self.share_tokens else None,
                    lazy=True, tenant=ws.tenant)
            if st is None:
                break                       # no slot/pages: keep waiting
            del self.waiting[idx]           # idx==0 unless quota-skipping
            self.buffer.attach(st.slot, ws.seq_id, ws.tokens,
                               st.prefill_start)
            self.running.append(ws.seq_id)
            self._pending_tok[ws.seq_id] = ws.pending
            if ws.preempted:
                self.resumes += 1
                out.resumed.append(ws.seq_id)
                self._emit(("resume", ws.seq_id, list(st.pages)))
            else:
                out.admitted.append(ws.seq_id)
            self._emit(("map", list(st.pages[st.shared_pages:]),
                        st.slot, list(st.pages)))
        # 3. Compose the mixed step under the token budget.
        for sid in self.running:
            slot = self.buffer.slot_of(sid)
            if self._decodes_here(sid, slot):
                out.decode_slots.append(slot)
        out.n_decode_tokens = len(out.decode_slots)
        budget = self.token_budget - out.n_decode_tokens
        p = self.mgr.page_size
        for sid in self.running:
            if budget <= 0:
                break
            slot = self.buffer.slot_of(sid)
            if self.buffer.is_decoding(slot):
                continue
            s = int(self.buffer.n_computed[slot])
            prompt_len = int(self.buffer.prompt_lens[slot])
            remaining = prompt_len - s
            take = min(budget, self.prefill_chunk, remaining)
            if take == remaining:
                e = prompt_len
            else:
                e = ((s + take) // p) * p    # non-final chunks end on a page
                if e <= s:
                    continue                 # no budget for a full page
            pend = self._pending_tok.pop(sid, None) if e == prompt_len \
                else None
            out.chunks.append(ChunkSpan(sid, slot, s, e, e == prompt_len,
                                        pend))
            budget -= e - s
            out.n_chunk_tokens += e - s
        return out

    def _decodes_here(self, seq_id: int, slot: int) -> bool:
        """Does this sequence decode on THIS scheduler's worker? The base
        (colocated) scheduler decodes every sequence that finished prefill;
        a disaggregated prefill worker overrides this to False — finished
        prefills wait (still preemptible) for the transfer engine to
        migrate them to the decode worker."""
        return self.buffer.is_decoding(slot)

    def _quota_blocked(self, ws: WaitingSeq) -> bool:
        """Would admitting ``ws`` right now push its tenant over quota?
        Mirrors ``admit``'s transient quota gate for the lazy page need, so
        the waiting-queue scan skips entries that would just bounce."""
        quota = self.mgr.tenant_quota(ws.tenant)
        if not quota:
            return False
        need = max(-(-len(ws.tokens) // self.mgr.page_size), 1)
        return self.mgr.tenant_pages_used(ws.tenant) + need > quota

    # ------------------------------------------------------------ preempt
    def _preempt_one(self) -> Tuple[int, List[int]]:
        """Preempt the newest-admitted running sequence: register its
        computed KV for re-match, tear down its slot/pages/ASID, and queue
        it (front) for resume. Returns (seq_id, folded generated tokens)."""
        return self._preempt_sid(self.running[-1])

    def _preempt_sid(self, sid: int) -> Tuple[int, List[int]]:
        """Preempt a specific running sequence (quota preemption picks by
        tenant, not strictly newest-overall)."""
        self.running.remove(sid)
        slot = self.buffer.slot_of(sid)
        st = self.mgr.seqs[sid]
        pending = self._pending_tok.pop(sid, None)
        if self.buffer.is_decoding(slot):
            # Exactly one token is pending (never KV-written): it becomes
            # the resume's re-injected first token; every other known token
            # is KV-resident and becomes the resume prompt.
            toks = self.buffer.tokens(slot)
            resident = toks[:-1]
            ws = WaitingSeq(sid, resident,
                            st.max_tokens - len(st.tokens) + 1,
                            pending=toks[-1], preempted=True)
            folded = list(st.tokens[:-1])
        else:
            # Mid-prefill: KV is resident for the computed chunk prefix
            # only; the resume re-admits the original prompt (re-matching
            # the registered chunks) with its budget untouched. ``pending``
            # survives a second preemption of a not-yet-resumed sequence.
            prompt = self.buffer.tokens(slot)
            resident = prompt[:int(self.buffer.n_computed[slot])]
            ws = WaitingSeq(sid, prompt, st.max_tokens,
                            pending=pending, preempted=True)
            folded = []
        self._emit(("preempt", sid))
        n_pages = len(st.pages)
        self.mgr.preempt(sid, resident)
        self._emit(("unmap", slot, n_pages))
        self.buffer.detach(slot)
        self.waiting.appendleft(ws)
        self.preemptions += 1
        return sid, folded

    def _emit(self, ev: tuple) -> None:
        if self.on_event is not None:
            self.on_event(ev)

    def stats(self) -> dict:
        return {"preemptions": self.preemptions, "resumes": self.resumes,
                "waiting": len(self.waiting), "running": len(self.running)}
