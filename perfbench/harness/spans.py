"""Spans and counters that the harness records around its own calls into the
port's layers. Kept in memory and read once the window has closed.

A span is (name, start, end, attrs) on the host's `perf_counter` clock;
attrs says what the call carried (frames and bucket of a batch, ...). A
traced run reads them to tell what the host was doing in a gap between
device operations (`trace.py`).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

Span = Tuple[str, float, float, dict]


class Spans:
    def __init__(self):
        self._spans: List[Span] = []
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str, **attrs):
        t0 = time.perf_counter()
        yield
        t1 = time.perf_counter()
        with self._lock:
            self._spans.append((name, t0, t1, attrs))

    def of(self, name: str, start: float = float("-inf"), end: float = float("inf")) -> List[Span]:
        """The spans called `name` that began in [start, end)."""
        with self._lock:
            return [s for s in self._spans if s[0] == name and start <= s[1] < end]

    def mean_ms(self, name: str, start: float = float("-inf"), end: float = float("inf")):
        spans = self.of(name, start, end)
        if not spans:
            return None
        return sum(s[2] - s[1] for s in spans) / len(spans) * 1e3

    def names(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for s in self._spans:
                out[s[0]] = out.get(s[0], 0) + 1
            return out
