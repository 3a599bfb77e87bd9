"""Fault tolerance: heartbeats, straggler detection, failure injection, and
the checkpoint/restart orchestration used by launch/train.py.

On a real cluster the heartbeat source is the coordinator's liveness RPC;
here it is process-local so the whole machinery is CPU-testable. The restart
loop is the piece that matters at 1000+ nodes: any step-time exception rolls
back to the last committed checkpoint and continues, and the restore path is
elastic (a different mesh shape reshards the same checkpoint).
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class WorkerFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Deterministic fault injection for tests: fail at given step numbers."""
    fail_at_steps: tuple = ()
    kind: str = "worker"
    _fired: set = field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise WorkerFailure(f"injected {self.kind} failure at step {step}")


class HeartbeatMonitor:
    """Tracks per-worker heartbeats; ``dead_workers`` after a timeout."""

    def __init__(self, workers: List[str], timeout_s: float = 30.0):
        self.timeout_s = timeout_s
        self.last: Dict[str, float] = {w: time.monotonic() for w in workers}

    def beat(self, worker: str):
        self.last[worker] = time.monotonic()

    def dead_workers(self) -> List[str]:
        now = time.monotonic()
        return [w for w, t in self.last.items() if now - t > self.timeout_s]

    def assert_alive(self):
        dead = self.dead_workers()
        if dead:
            raise WorkerFailure(f"workers missed heartbeat: {dead}")


class StragglerDetector:
    """Flags steps slower than ``factor`` x the rolling median step time.

    At pod scale the mitigation hook would reassign the slow host's shard;
    here we record and expose the events (and tests assert detection).
    """

    def __init__(self, window: int = 32, factor: float = 3.0):
        self.times = collections.deque(maxlen=window)
        self.factor = factor
        self.events: List[dict] = []

    def record(self, step: int, seconds: float) -> bool:
        med = (sorted(self.times)[len(self.times) // 2]
               if len(self.times) >= 8 else None)
        self.times.append(seconds)
        if med is not None and seconds > self.factor * med:
            self.events.append({"step": step, "seconds": seconds,
                                "median": med})
            return True
        return False


def run_with_restarts(train_loop: Callable[[Optional[int]], int],
                      max_restarts: int = 3) -> int:
    """Run ``train_loop(resume_step)``; on WorkerFailure, restart from the
    last checkpoint. Returns the final step. ``train_loop`` must itself
    restore state from its checkpoint dir when ``resume_step`` is not None."""
    restarts = 0
    resume: Optional[int] = None
    while True:
        try:
            return train_loop(resume)
        except WorkerFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            resume = -1     # sentinel: restore from latest
            print(f"[ft] {e}; restart {restarts}/{max_restarts} "
                  f"from latest checkpoint", flush=True)
