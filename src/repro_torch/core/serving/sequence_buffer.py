"""Dense per-slot sequence state for the continuous-batching engine.

The fixed-slot engine keeps request state in per-``Request`` Python lists;
every step walks dicts to assemble the decode batch. Continuous batching
(``core/serving/scheduler.py``) composes a *mixed* step — decode tokens
plus chunked-prefill slices — every iteration, so step assembly must be
vectorized: this buffer holds one contiguous numpy row per batch slot
(token ids, counts, prefill progress, slot-mapping metadata) and derives
the per-step arrays (last decode token per slot, decode mask, chunk token
slices) with array ops instead of Python-object walks.

Layout (all arrays indexed by SLOT, the same index as the manager's block
tables and the device cache rows — one slot == one ASID):

  token_ids   (n_slots, max_len) int32   prompt then generated tokens
  n_tokens    (n_slots,) int32           known tokens (prompt + generated)
  n_computed  (n_slots,) int32           prompt positions whose KV is
                                         resident (chunked-prefill progress;
                                         == prompt_lens once decoding)
  prompt_lens (n_slots,) int32           prompt length of the resident seq
  seq_ids     (n_slots,) int64           owning sequence id, -1 = free

The jit'd step functions never see this object — the engine feeds them
padded arrays derived here, so precompiled shapes stay stable (power-of-two
token buckets, fixed batch width). Host-side only: nothing in this module
is jit-traced.

Invariants (pinned by ``tests/test_scheduler.py``):
  * a DECODING slot (``n_computed == prompt_lens``) has ``n_tokens >=
    prompt_lens + 1``: exactly one token is pending (fed to the next decode
    step), matching the manager's ``SeqState.length`` bookkeeping;
  * a PREFILLING slot has ``n_tokens == prompt_lens`` (no appends until the
    final chunk produces the first token);
  * ``detach`` zeroes the row, so a recycled slot can never leak a dead
    sequence's tokens into a padded batch.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


class SequenceBuffer:
    """Contiguous per-slot sequence state (see module docstring)."""

    def __init__(self, n_slots: int, max_len: int):
        if n_slots < 1:
            raise ValueError(f"n_slots={n_slots} (need >= 1)")
        if max_len < 1:
            raise ValueError(f"max_len={max_len} (need >= 1)")
        self.n_slots = n_slots
        self.max_len = max_len
        self.token_ids = np.zeros((n_slots, max_len), np.int32)
        self.n_tokens = np.zeros((n_slots,), np.int32)
        self.n_computed = np.zeros((n_slots,), np.int32)
        self.prompt_lens = np.zeros((n_slots,), np.int32)
        self.seq_ids = np.full((n_slots,), -1, np.int64)
        self._slot_by_seq: Dict[int, int] = {}

    # ------------------------------------------------------------ lifecycle
    def attach(self, slot: int, seq_id: int, tokens: List[int],
               prefill_start: int = 0) -> None:
        """Bind ``seq_id`` to ``slot`` with its prompt tokens. A prefix-cache
        match sets ``prefill_start`` (leading positions whose KV is already
        resident — chunked prefill starts there)."""
        if self.seq_ids[slot] >= 0:
            raise ValueError(f"slot {slot} already holds seq "
                             f"{int(self.seq_ids[slot])}")
        n = len(tokens)
        if n > self.max_len:
            raise ValueError(f"prompt of {n} tokens exceeds max_len="
                             f"{self.max_len}")
        self.token_ids[slot, :n] = tokens
        self.token_ids[slot, n:] = 0
        self.n_tokens[slot] = n
        self.n_computed[slot] = prefill_start
        self.prompt_lens[slot] = n
        self.seq_ids[slot] = seq_id
        self._slot_by_seq[seq_id] = slot

    def detach(self, slot: int) -> None:
        sid = int(self.seq_ids[slot])
        if sid >= 0:
            self._slot_by_seq.pop(sid, None)
        self.token_ids[slot] = 0
        self.n_tokens[slot] = 0
        self.n_computed[slot] = 0
        self.prompt_lens[slot] = 0
        self.seq_ids[slot] = -1

    # ------------------------------------------------------------- updates
    def append(self, slot: int, token: int) -> None:
        """Record one generated token (decode output, or the final chunk's
        first token)."""
        n = int(self.n_tokens[slot])
        if n >= self.max_len:
            raise ValueError(f"slot {slot} overflows max_len={self.max_len}")
        self.token_ids[slot, n] = token
        self.n_tokens[slot] = n + 1

    def advance(self, slot: int, computed: int) -> None:
        """Mark prompt positions ``[0, computed)`` as KV-resident (a chunk
        completed). Monotonic; capped by the prompt length."""
        cur = int(self.n_computed[slot])
        if computed < cur or computed > int(self.prompt_lens[slot]):
            raise ValueError(
                f"slot {slot}: advance to {computed} out of range "
                f"[{cur}, {int(self.prompt_lens[slot])}]")
        self.n_computed[slot] = computed

    # -------------------------------------------------------------- queries
    def slot_of(self, seq_id: int) -> int:
        return self._slot_by_seq[seq_id]

    def is_decoding(self, slot: int) -> bool:
        return (self.seq_ids[slot] >= 0
                and self.n_computed[slot] >= self.prompt_lens[slot])

    def tokens(self, slot: int) -> List[int]:
        """All known tokens of the resident sequence (prompt + generated)."""
        return self.token_ids[slot, :int(self.n_tokens[slot])].tolist()

    def chunk_tokens(self, slot: int, start: int, end: int) -> np.ndarray:
        """Prompt token slice ``[start, end)`` for a chunked-prefill span."""
        return self.token_ids[slot, start:end]

    # -------------------------------------------------- step assembly (vec)
    def last_tokens(self) -> np.ndarray:
        """(n_slots,) int32: each slot's latest known token (0 for free
        slots) — the decode step's input token, gathered in one op."""
        idx = np.maximum(self.n_tokens - 1, 0)
        out = self.token_ids[np.arange(self.n_slots), idx]
        return np.where(self.n_tokens > 0, out, 0).astype(np.int32)

    def decode_mask(self) -> np.ndarray:
        """(n_slots,) bool: slots whose sequence finished prefill (decode
        candidates)."""
        return (self.seq_ids >= 0) & (self.n_computed >= self.prompt_lens)

    @property
    def n_active(self) -> int:
        return int((self.seq_ids >= 0).sum())
