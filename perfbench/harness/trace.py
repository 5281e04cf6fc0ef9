"""The traced run's device timeline, from `torch.profiler` (CUPTI).

`Tracer.open()` starts the profiler in set-up, before the window: its
start stalls the process for most of a second, which inside the window
would pile requests up and let a burst through the sub-window. `start()` /
`stop()` bracket a sub-window of the measured window with a host
annotation, `perfbench.window`, and `close()` ends the profile after the
window; everything is read on the profiler's own clock and clipped to that
annotation. `TraceData` holds the
device operations (kernels, copies, sets) and gives the union of the device's busy intervals, its idle gaps labelled
by what the host was doing, and device time by name. The host's doing
is read from the harness's own spans (`spans.py`), whose clock is mapped
onto the profiler's by the two ends of the sub-window: the profiler records
host operations of the thread that started it, not of the server's.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "perfbench.window"


@dataclass
class TraceData:
    window: Tuple[float, float]  # profiler clock, seconds
    host_window: Tuple[float, float]  # perf_counter at the same two moments
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: list = field(default_factory=list)  # the harness's (name, start, end, attrs), host clock

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        ivs = sorted((max(s, lo), min(e, hi)) for _, s, e in self.device if e > lo and s < hi)
        merged: List[List[float]] = []
        for s, e in ivs:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def gaps(self) -> List[Tuple[float, float]]:
        lo, hi = self.window
        out, t = [], lo
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if hi > t:
            out.append((t, hi))
        return out

    def device_time_by_name(self) -> Dict[str, float]:
        lo, hi = self.window
        out: Dict[str, float] = {}
        for name, s, e in self.device:
            d = min(e, hi) - max(s, lo)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
        return out

    def kernels(self, pattern: str) -> List[Tuple[str, float, float]]:
        """Device operations whose name matches `pattern` and that began
        inside the window."""
        rx = re.compile(pattern)
        lo, hi = self.window
        return [k for k in self.device if rx.search(k[0]) and lo <= k[1] < hi]

    def host_time(self, t: float) -> float:
        (ws, we), (h0, h1) = self.window, self.host_window
        return h0 + (t - ws) * (h1 - h0) / max(we - ws, 1e-12)

    def host_label(self, t: float) -> str:
        """What the host was doing at profiler time t, by the harness's
        spans: inside a device call of the server (its batch), or between
        device calls, with the number of requests being submitted."""
        h = self.host_time(t)
        here = [s for s in self.spans if s[1] <= h < s[2]]
        inside = [s for s in here if s[0] == "device_call"]
        if inside:
            return f"inside device_call (bucket {inside[0][3]['bucket']})"
        submits = sum(1 for s in here if s[0] == "submit")
        return f"between device calls ({submits} submit in progress)"

    def breakdown(self, n: int = 10) -> dict:
        ops = sorted(self.device_time_by_name().items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {
            "device_ops": [[name, secs] for name, secs in ops],
            "idle_gaps": [[self.host_label((s + e) / 2), e - s] for s, e in gaps],
        }


def _events(prof) -> Tuple[list, list]:
    """(device operations (name, start, end), host annotations (name,
    start, end)) of a finished profile, on its clock, in seconds."""
    device, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e9
        end = start + e.duration_ns() / 1e9
        if e.device_type() != cuda:
            host.append((e.name(), start, end))
        elif not e.name().startswith(("perfbench.", "ProfilerStep")):
            device.append((e.name(), start, end))
    return device, host


class Tracer:
    """Profiles from open() to close() and marks the sub-window from start()
    to stop(); all four are called on one thread."""

    def __init__(self):
        self._prof = None
        self._ann = None
        self.data: Optional[TraceData] = None

    def open(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()

    def start(self) -> None:
        self._ann = torch.profiler.record_function(WINDOW)
        self._ann.__enter__()
        self._h0 = time.perf_counter()

    def stop(self) -> None:
        self._h1 = time.perf_counter()
        self._ann.__exit__(None, None, None)

    def close(self) -> None:
        if torch.cuda.is_available():  # the kernels in flight at the close are recorded, then clipped
            torch.cuda.synchronize()
        self._prof.stop()
        device, host = _events(self._prof)
        marks = [h for h in host if h[0] == WINDOW]
        if not marks:
            raise RuntimeError("the profile holds no window annotation")
        _, ws, we = marks[0]
        self.data = TraceData((ws, we), (self._h0, self._h1), device)
        self._prof = None
