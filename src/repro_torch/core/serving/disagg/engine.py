"""Disaggregated serving front-end: one engine, two workers, one pool
(port of ``repro/core/serving/disagg/engine.py``; ``mi`` is passed on to
every forward, as the reference's).

``DisaggEngine`` splits the continuous engine's slot range into a prefill
worker (slots ``[0, n_prefill)``, driven by a :class:`PrefillScheduler`)
and a decode worker (slots ``[n_prefill, n_slots)``, reserved away from
admission), connected by a :class:`KVTransferEngine`. Each step runs the
pipeline

    admit/resume -> chunked prefill -> detect finished prefills ->
    pump transfers (migrate KV prefill-ASID -> decode-ASID) ->
    masked decode over the decode worker's slots

Migration goes through ``PagedKVManager.migrate``: the source ASID
translates every page through the transfer IOMMU (modeled remote DMA —
PTW/IOTLB cost in the ``transfer:`` stats block), then either re-attaches
the pages zero-copy (``share``: ``PagePool.share`` + table hand-off) or
duplicates them device-side (``copy``: batched through the engine's CoW
page copy, ``_cow_copy_pages``). Because the device batch runs at FULL
slot width with non-decoding rows masked, and chunk composition/slot
placement never change token values, the disaggregated engine's outputs are bit-identical
to the colocated continuous engine at equal total width (held against the
JAX engines in ``tests/test_torch_disagg.py``).

Trace: migrations append ``("xfer", sid, n_pages, mode)`` followed by the
source ``unmap`` and destination ``map`` events, so a recorded trace
replays through the reference's trace replay unchanged.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.serving.disagg.workers import (DecodeWorker,
                                                     KVTransferEngine,
                                                     PrefillScheduler,
                                                     PrefillWorker)
from repro_torch.core.serving.engine import Request, ServingEngine
from repro_torch.core.serving.scheduler import SchedulerOutput, WaitingSeq
from repro_torch.core.sva.iommu import IOMMU
from repro_torch.models.dist import NO_MESH, MeshInfo


class DisaggEngine(ServingEngine):
    """Prefill/decode-disaggregated continuous engine (single process)."""

    def __init__(self, cfg: ModelConfig, params, n_prefill_slots: int,
                 n_decode_slots: int, max_len: int, page_size: int = 8,
                 mi: MeshInfo = NO_MESH, disagg_mode: str = "share",
                 xfer_iommu: Optional[IOMMU] = None, **kw):
        if disagg_mode not in ("share", "copy"):
            raise ValueError(f"disagg_mode={disagg_mode!r} "
                             "(expected 'share' or 'copy')")
        if n_prefill_slots < 1 or n_decode_slots < 1:
            raise ValueError("need >= 1 prefill and >= 1 decode slot "
                             f"(got {n_prefill_slots}/{n_decode_slots})")
        self.disagg_mode = disagg_mode
        # The transfer fabric's IOMMU (e.g. a 4-entry IOTLB over Sv39Walk)
        # prices migrations; None prices them through the manager's own.
        self.xfer_iommu = xfer_iommu
        self.xfer_engine: Optional[KVTransferEngine] = None
        super().__init__(cfg, params,
                         n_slots=n_prefill_slots + n_decode_slots,
                         max_len=max_len, page_size=page_size, mi=mi,
                         scheduler="continuous", **kw)
        self.n_prefill_slots = n_prefill_slots
        self.n_decode_slots = n_decode_slots
        prefill_slots = list(range(n_prefill_slots))
        decode_slots = list(range(n_prefill_slots, self.n_slots))
        # The prefill worker's scheduler replaces the colocated one: same
        # admission/preemption machinery, no decode composition, preemption
        # floor 0 (decode growth may reclaim every prefill page).
        self.sched = PrefillScheduler(self.mgr, self.buffer,
                                      cfg.sched_token_budget,
                                      cfg.sched_prefill_chunk,
                                      share_tokens=self._can_share,
                                      on_event=self._trace_event)
        # Decode slots never appear in admission: migration targets them.
        self.mgr.reserve_slots(decode_slots)
        self.prefill_worker = PrefillWorker(prefill_slots, self.sched,
                                            self.buffer, self.mgr)
        self.decode_worker = DecodeWorker(decode_slots, self.buffer)
        self.xfer_engine = KVTransferEngine(self, disagg_mode, decode_slots)

    # ------------------------------------------------------------ step
    def _continuous_step(self):
        # Pending device page copies (CoW divergences AND copy-mode
        # transfer payloads) must land before anything can recycle their
        # source pages — same invariant as the colocated step.
        self._apply_cow()
        while self.queue:
            req = self.queue.popleft()
            self.sched.submit(req.req_id, req.prompt, req.max_tokens,
                              tenant=req.tenant)
            self._waiting_reqs[req.req_id] = req
        t0 = time.perf_counter()
        out = self.sched.schedule()
        self.metrics["admit_s"] += time.perf_counter() - t0
        for sid, folded in out.preempted:
            req = self.active.pop(sid)
            req.out_tokens.extend(folded)
            self._waiting_reqs[sid] = req
        for sid in out.admitted + out.resumed:
            self.active[sid] = self._waiting_reqs.pop(sid)
        if out.chunks:
            self._chunk_prefill(out.chunks)
        # Prefill-complete sequences queue for migration; the pump moves
        # as many as free decode slots (and, copy mode, pool headroom)
        # allow this step.
        for sid in self.prefill_worker.ready_for_handoff():
            self.xfer_engine.enqueue(sid)
        self.xfer_engine.pump()
        # Copy-mode deadlock break: a blocked transfer with an IDLE decode
        # worker can never unblock on its own (nothing downstream will
        # free pages) — force-preempt the newest prefill until the oldest
        # queued transfer fits. Terminates: each preempt shrinks running.
        while (self.xfer_engine.blocked and not self.decode_worker.running
               and len(self.sched.running) > 1):
            sid, folded = self.sched._preempt_one()
            req = self.active.pop(sid)
            req.out_tokens.extend(folded)
            self._waiting_reqs[sid] = req
            self.xfer_engine.pump()
        # Decode-side preemption: the prefill scheduler's pressure loop
        # only sees ITS running sequences, but decode growth (page-boundary
        # appends, CoW divergences) draws on the same pool. When demand
        # still exceeds headroom after the prefill side yielded everything
        # it can, the newest decode sequence preempts back to the waiting
        # queue (same fold/pending/rebase discipline as the scheduler's) —
        # it re-prefills from warm prefix pages and transfers again.
        while (self.decode_worker.running
               and len(self.decode_worker.running)
               + len(self.sched.running) > 1
               and self.mgr.next_step_page_demand()
               > self.mgr.free_page_headroom()):
            self._preempt_decode_one()
        dec = SchedulerOutput(decode_slots=self.decode_worker.decode_slots())
        dec.n_decode_tokens = len(dec.decode_slots)
        self._decode_continuous(dec)

    def _preempt_decode_one(self) -> None:
        """Preempt the newest decode-worker sequence under pool pressure:
        exactly one token is pending (never KV-written) — it becomes the
        resume's re-injected first token; every other known token is
        KV-resident and becomes the resume prompt. The freed decode slot
        returns to the transfer engine."""
        sid = self.decode_worker.running[-1]
        slot = self.buffer.slot_of(sid)
        st = self.mgr.seqs[sid]
        toks = self.buffer.tokens(slot)
        resident = toks[:-1]
        ws = WaitingSeq(sid, resident, st.max_tokens - len(st.tokens) + 1,
                        pending=toks[-1], preempted=True)
        folded = list(st.tokens[:-1])
        self._trace_event(("preempt", sid))
        n_pages = len(st.pages)
        self.mgr.preempt(sid, resident)
        self._trace_event(("unmap", slot, n_pages))
        self.decode_worker.running.pop()
        self.buffer.detach(slot)
        self.sched.waiting.appendleft(ws)
        self.sched.preemptions += 1
        req = self.active.pop(sid)
        req.out_tokens.extend(folded)
        self._waiting_reqs[sid] = req
        # preempt() returned the slot to general admission; reclaim it as
        # a migration target.
        self.mgr.reserve_slots([slot])
        self.xfer_engine.free_decode.append(slot)

    # ------------------------------------------------------------ migrate
    def _migrate(self, seq_id: int, dst_slot: int) -> None:
        """Move one finished prefill to the decode worker: manager-level
        page/ASID migration (priced through the transfer IOMMU), then the
        buffer row re-attaches on the decode side with the prompt resident
        and exactly the first generated token pending — the same decoding
        invariant a colocated sequence has after its final chunk."""
        st = self.mgr.seqs[seq_id]
        src_slot = st.slot
        toks = self.buffer.tokens(src_slot)
        n_pages = len(st.pages)
        # Raises OutOfPages (copy mode) with nothing mutated; pump defers.
        self.mgr.migrate(seq_id, dst_slot, mode=self.disagg_mode,
                         xfer_iommu=self.xfer_iommu)
        self.sched.handoff(seq_id)
        self.buffer.detach(src_slot)
        self.buffer.attach(dst_slot, seq_id, toks[:-1],
                           prefill_start=len(toks) - 1)
        self.buffer.append(dst_slot, toks[-1])
        self.decode_worker.running.append(seq_id)
        if self.translation_trace is not None:
            new_pages = list(self.mgr.seqs[seq_id].pages)
            fresh = new_pages if self.disagg_mode == "copy" else []
            self.translation_trace.append(
                ("xfer", seq_id, n_pages, self.disagg_mode))
            self.translation_trace.append(("unmap", src_slot, n_pages))
            self.translation_trace.append(("map", fresh, dst_slot,
                                           new_pages))

    # ------------------------------------------------------------ hooks
    def _trace_event(self, ev: tuple) -> None:
        # A preempted sequence's KV is gone: cancel its queued transfer
        # (it re-queues when the resume finishes prefill). This must run
        # whether or not a trace is being recorded.
        if ev and ev[0] == "preempt" and self.xfer_engine is not None:
            self.xfer_engine.cancel(ev[1])
        super()._trace_event(ev)

    def _resident_tokens(self) -> Dict[int, int]:
        resident = super()._resident_tokens()
        for sid in self.decode_worker.running:
            resident[sid] = self.mgr.seqs[sid].length
        return resident

    def _release_done(self, finished: Dict[int, Request]) -> None:
        for rid in [r for r, q in self.active.items()
                    if self.mgr.seqs[r].done]:
            req = self.active.pop(rid)
            req.done_at = time.perf_counter()
            st = self.mgr.seqs[rid]
            slot = st.slot
            req.out_tokens.extend(st.tokens)
            if rid in self.decode_worker.running:
                self.decode_worker.finish(rid)
            else:
                # Completed at prefill (max_tokens == 1 / EOS first token):
                # never migrated, still the prefill scheduler's.
                self.sched.finish(rid)
            if self.translation_trace is not None:
                self.translation_trace.append(
                    ("unmap", slot, len(st.pages)))
            self.mgr.release(rid)
            finished[rid] = req
            if slot in self.decode_worker.slots:
                # release() returned the slot to general admission; pull it
                # back out — decode slots are only ever migration targets.
                self.mgr.reserve_slots([slot])
                self.xfer_engine.free_decode.append(slot)

    def stats(self) -> dict:
        s = super().stats()
        block = {"mode": self.disagg_mode,
                 "prefill_slots": self.n_prefill_slots,
                 "decode_slots": self.n_decode_slots,
                 "decoding": len(self.decode_worker.running),
                 **self.xfer_engine.stats()}
        if self.xfer_iommu is not None:
            block["xfer_iommu"] = self.xfer_iommu.stats()
        s["disagg"] = block
        return s
