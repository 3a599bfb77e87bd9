"""Worker-side pieces of the disaggregated engine: the prefill worker's
scheduler specialization, the decode worker's run list, and the transfer
engine that moves finished prefills between them.

All three operate on state OWNED elsewhere (the manager, the shared
``SequenceBuffer``, the engine's request map) — they partition
responsibility, not data: one pool, one IOMMU, one buffer, split by slot
range. Page-pool verbs stay inside :class:`PagedKVManager` (svalint
R002); the transfer engine only sequences ``DisaggEngine._migrate``
calls."""
from __future__ import annotations

from collections import deque
from typing import Deque, List, Sequence, Set

from repro_torch.core.serving.scheduler import Scheduler
from repro_torch.core.serving.sequence_buffer import SequenceBuffer
from repro_torch.core.sva.kv_manager import PagedKVManager
from repro_torch.core.sva.page_pool import OutOfPages


class PrefillScheduler(Scheduler):
    """The colocated scheduler minus decode: every token-budget point goes
    to chunked prefill. A sequence that finishes its prompt (buffer says
    decoding) is NOT stepped here — it parks, still preemptible under pool
    pressure, until the :class:`KVTransferEngine` migrates it out. The
    preemption floor drops to 0 because forward progress belongs to the
    decode worker (see ``Scheduler.min_running``)."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.min_running = 0

    def _decodes_here(self, seq_id: int, slot: int) -> bool:
        return False


class PrefillWorker:
    """Admission + chunked prefill over the prefill slot range. Thin facade:
    the scheduler does the work; the worker adds hand-off detection."""

    def __init__(self, slots: Sequence[int], sched: Scheduler,
                 buffer: SequenceBuffer, mgr: PagedKVManager):
        self.slots = list(slots)
        self.sched = sched
        self.buffer = buffer
        self.mgr = mgr

    def ready_for_handoff(self) -> List[int]:
        """Sequences whose prefill completed this step (first token
        appended, buffer row decoding) and that still have decoding left
        to do — a prompt whose budget was exactly one token completes in
        place and never transfers."""
        out = []
        for sid in list(self.sched.running):
            slot = self.buffer.slot_of(sid)
            if self.buffer.is_decoding(slot) and not self.mgr.seqs[sid].done:
                out.append(sid)
        return out


class DecodeWorker:
    """The masked decode loop's run list over the decode slot range. The
    engine composes its ``decode_slots()`` into the step; completion
    teardown mirrors ``Scheduler.finish``."""

    def __init__(self, slots: Sequence[int], buffer: SequenceBuffer):
        self.slots = list(slots)
        self.buffer = buffer
        self.running: List[int] = []          # arrival order

    def decode_slots(self) -> List[int]:
        return [self.buffer.slot_of(sid) for sid in self.running]

    def finish(self, seq_id: int) -> None:
        """A decode-side sequence completed (the engine releases it):
        drop run-list + buffer state. Called BEFORE ``release``."""
        slot = self.buffer.slot_of(seq_id)
        self.running.remove(seq_id)
        self.buffer.detach(slot)


class KVTransferEngine:
    """FIFO of finished prefills awaiting migration to a free decode slot.

    ``pump()`` drains the queue head-first each step through
    ``DisaggEngine._migrate`` (which prices the hand-off through the
    transfer IOMMU and re-attaches pages/tables/buffer row). A copy-mode
    transfer that cannot back its fresh pages — the pool raises
    ``OutOfPages``, or the duplicate would eat the headroom this step's
    decode growth needs — defers WITHOUT mutating anything; the engine
    breaks a true deadlock (blocked transfer + idle decode worker) by
    force-preempting the newest prefill. A preempted sequence's queued
    transfer is cancelled (the engine's trace hook calls :meth:`cancel`)
    and re-queued when its resume finishes prefill again."""

    def __init__(self, engine, mode: str, decode_slots: Sequence[int]):
        self.engine = engine
        self.mode = mode
        self.queue: Deque[int] = deque()
        self._queued: Set[int] = set()
        self.free_decode = list(decode_slots)  # pop from the tail
        self.blocked = False                   # last pump hit OutOfPages
        self.transfers = 0
        self.deferred = 0
        self.cancelled = 0

    def enqueue(self, seq_id: int) -> None:
        if seq_id not in self._queued:
            self._queued.add(seq_id)
            self.queue.append(seq_id)

    def cancel(self, seq_id: int) -> None:
        """The prefill worker preempted a sequence with a pending
        transfer: its KV is gone, so the transfer must not run. The
        resume's hand-off detection re-queues it."""
        if seq_id in self._queued:
            self._queued.discard(seq_id)
            self.queue.remove(seq_id)
            self.cancelled += 1

    def pump(self) -> None:
        mgr = self.engine.mgr
        self.blocked = False
        while self.queue and self.free_decode:
            sid = self.queue[0]
            if self.mode == "copy":
                # Don't let the duplicate starve this step's decode
                # appends: they cannot wait (OutOfPages mid-step), a
                # transfer can.
                need = len(mgr.seqs[sid].pages)
                if (mgr.free_page_headroom() - need
                        < mgr.next_step_page_demand()):
                    self.blocked = True
                    self.deferred += 1
                    break
            try:
                self.engine._migrate(sid, self.free_decode[-1])
            except OutOfPages:
                self.blocked = True
                self.deferred += 1
                break
            self.queue.popleft()
            self._queued.discard(sid)
            self.free_decode.pop()
            self.transfers += 1

    def stats(self) -> dict:
        return {"transfers": self.transfers, "deferred": self.deferred,
                "cancelled": self.cancelled, "pending": len(self.queue),
                "free_decode_slots": len(self.free_decode)}
