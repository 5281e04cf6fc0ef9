"""What a driver hands back: every request of the window, and the window's
bounds on the host clock. Also the main thread's part of a window: it
holds the window open for its length and, in a traced run, profiles a
sub-window of it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

TRACE_LEAD_S = 1.0  # the traced sub-window starts this far into the window
TRACE_MAX_S = 3.0  # and lasts at most this long


@dataclass
class Request:
    pool_index: int
    start: float  # send time (closed loop) or due time (open loop), perf_counter
    end: Optional[float] = None  # reply time; None if never answered
    reply: object = None  # kept for the requests the seed picked for the check
    error: Optional[str] = None


@dataclass
class Window:
    start: float
    end: float
    requests: List[Request] = field(default_factory=list)
    notes: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def answered(self) -> List[Request]:
        return [r for r in self.requests if r.error is None and r.end is not None]

    def failed(self) -> int:
        return sum(1 for r in self.requests if r.error is not None or r.end is None)


def hold(start: float, seconds: float, tracer=None) -> None:
    """Sleep to start + seconds; profile [start + lead, + length) if traced."""
    if tracer is not None:
        lead = min(TRACE_LEAD_S, seconds * 0.1)
        length = min(TRACE_MAX_S, seconds - lead)
        _sleep_until(start + lead)
        tracer.start()
        _sleep_until(start + lead + length)
        tracer.stop()
    _sleep_until(start + seconds)


def _sleep_until(t: float) -> None:
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(min(left, 0.05))


def keep_mask(seed: int, stream: int, n: int, share: float):
    """Which of a stream's first n requests keep their reply for the check:
    a share of them, drawn from the seed. The rest are dropped on arrival,
    so the window holds few reply objects."""
    return np.random.default_rng([int(seed) % (2 ** 63), 8, stream]).random(n) < share
