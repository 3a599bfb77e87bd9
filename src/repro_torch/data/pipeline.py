"""Synthetic tokenized data pipeline with background host prefetch.

Produces packed (tokens, labels) batches from a deterministic zipfian
"language" (so loss curves are reproducible), with a prefetch thread that
stages the next batch while the device computes — the host side of the
paper's zero-copy story (no staging copies between generator and device
buffers; arrays are handed to jax.device_put directly, donated per step).
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclass
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2
    # markov blending makes the stream learnable (loss visibly decreases)
    markov_order: int = 1


class SyntheticLM:
    """Deterministic zipf+markov token stream, packed into LM batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        base = 1.0 / np.power(np.arange(1, v + 1), cfg.zipf_a)
        self.base = base / base.sum()
        # one shared sparse transition structure: each token prefers a few
        # successors — gives the model something to learn.
        self.succ = self.rng.integers(0, v, size=(v, 4))

    def _gen_doc(self, length: int) -> np.ndarray:
        v = self.cfg.vocab_size
        out = np.empty(length, np.int64)
        tok = int(self.rng.choice(v, p=self.base))
        for i in range(length):
            out[i] = tok
            if self.rng.random() < 0.7:
                tok = int(self.succ[tok, self.rng.integers(0, 4)])
            else:
                tok = int(self.rng.choice(v, p=self.base))
        return out

    def batches(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        B, S = self.cfg.batch, self.cfg.seq_len
        while True:
            stream = self._gen_doc(B * (S + 1))
            chunk = stream.reshape(B, S + 1)
            yield chunk[:, :-1].astype(np.int32), chunk[:, 1:].astype(np.int32)


class Prefetcher:
    """Stages ``depth`` batches ahead on a host thread."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.it = it
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        for item in self.it:
            if self._stop.is_set():
                return
            self.q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            self.q.get_nowait()
        except queue.Empty:
            pass


def make_pipeline(vocab_size: int, batch: int, seq_len: int, seed: int = 0,
                  prefetch: int = 2):
    ds = SyntheticLM(DataConfig(vocab_size, batch, seq_len, seed))
    return Prefetcher(ds.batches(), depth=prefetch)
