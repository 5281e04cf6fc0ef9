"""One run of one cell: set-up, the measured window, the reading of the
metrics, and the comparison with the plain reference.

    result = run_cell(workload, seed, seconds, trace, t_process)

Everything the cell needs is found by name (`registry.py`). The order is
the contract's: set-up (weights from the seed, the program's entry, the
request pool, warm-up) ends at the first request, which closes `setup_s`;
the window runs for `seconds`; then the device's memory peak is read, the
program is stopped and freed, and the reference checks a sample of the
replies, drawn from the seed.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from perfbench.harness import registry
from perfbench.harness.spans import Spans
from perfbench.harness.trace import TraceData, Tracer
from perfbench.harness.window import Window


@dataclass
class Context:
    """What a metric's reader gets."""

    config: dict
    setup_s: float
    window: Window
    spans: Spans
    counters: Dict[str, int]
    trace: Optional[TraceData] = None

    def counts(self, name: str):
        return registry.load_module("counts", name)

    def spans_in_trace(self, name: str):
        """(span, share of it inside the traced sub-window) for spans that
        overlap it."""
        if self.trace is None:
            return []
        lo, hi = self.trace.host_window
        out = []
        for s in self.spans.of(name):
            inside = min(s[2], hi) - max(s[1], lo)
            if inside > 0:
                out.append((s, inside / max(s[2] - s[1], 1e-12)))
        return out


def cell_config(cell: dict) -> tuple:
    """(configuration, traffic) of a cell."""
    return registry.load_json("configs", cell["config"]), registry.load_json("traffic", cell["traffic"])


def set_precision(cfg: dict) -> None:
    tf32 = bool(cfg["allow_tf32"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32


def buckets(spans: Spans, window: Window) -> Dict[str, int]:
    """Device calls that began in the window, by batch size."""
    out: Dict[str, int] = {}
    for s in spans.of("device_call", window.start, window.end):
        out[str(s[3]["bucket"])] = out.get(str(s[3]["bucket"]), 0) + 1
    return out


def span_means(spans: Spans, window: Window) -> Dict[str, float]:
    """Mean ms of each kind of span that began in the window, and of the
    host's turnaround between two device calls."""
    out = {name: spans.mean_ms(name, window.start, window.end) for name in spans.names()}
    calls = spans.of("device_call", window.start, window.end)
    if len(calls) > 1:
        out["between_device_calls"] = sum(b[1] - a[2] for a, b in zip(calls, calls[1:])) / (len(calls) - 1) * 1e3
    return out


def finite_or_none(x):
    return float(x) if x is not None and np.isfinite(x) else None


def sample_replies(window: Window, seed: int, n: int, compact):
    """[(pool index, compact reply)] of up to n answered requests that kept
    their reply, drawn from the seed."""
    kept = [r for r in window.answered() if r.reply is not None]
    rng = np.random.default_rng([int(seed) % (2 ** 63), 5])
    pick = rng.choice(len(kept), size=min(n, len(kept)), replace=False) if kept else []
    return [(kept[i].pool_index, compact(kept[i].reply)) for i in sorted(pick)]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, t_process: float,
             device="cuda", bench: Optional[dict] = None) -> dict:
    bench = registry.load_benchmark() if bench is None else bench
    cell = registry.find_workload(bench, workload)
    cfg, traffic = cell_config(cell)
    device = torch.device(device)
    set_precision(cfg)

    spans = Spans()
    parts = {"before_system": time.perf_counter() - t_process}
    system = registry.load_module("systems", cfg["system"]).System(cfg, seed, device, spans)
    parts["system"] = time.perf_counter() - t_process
    pool = system.pool(seed, int(traffic["pool"]))
    parts["pool"] = time.perf_counter() - t_process
    warm = traffic.get("warm", "all")
    system.warm(system.buckets() if warm == "all" else [int(b) for b in warm], pool[0])
    parts["warm"] = time.perf_counter() - t_process
    driver = registry.load_module("drivers", traffic["driver"])
    before = system.counters()
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    tracer = Tracer() if trace else None
    if tracer is not None:
        tracer.open()
    setup_s = time.perf_counter() - t_process
    window = driver.run(system, traffic, pool, seconds, seed, tracer)
    if tracer is not None:
        tracer.close()

    memory_peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    system.stop()
    gc.unfreeze()
    counters = {k: v - before.get(k, 0) for k, v in system.counters().items()}
    if tracer is not None:
        tracer.data.spans = [sp for name in spans.names() for sp in spans.of(name)]
    ctx = Context(cfg, setup_s, window, spans, counters, tracer.data if tracer else None)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for name, spec in registry.cell_metrics(bench, workload, section).items():
        kind = "metrics" if trace else "end_to_end"
        value = registry.load_module(kind, name).read(ctx)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": spec["unit"]}

    samples = sample_replies(window, seed, int(traffic["sample"]), system.compact)
    del system
    for r in window.requests:
        r.reply = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    readings = registry.load_module("reference", cfg["reference"]).check(cfg, seed, pool, samples, device)
    limits = cfg["limits"]
    checks = {k: {"value": finite_or_none(readings[k]), "limit": limits[k]} for k in limits}
    failed = window.failed()
    correct = (bool(samples) and failed == 0
               and all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values()))
    result = {
        "correct": correct,
        "attempted": len(window.requests),
        "failed": failed,
        "metrics": metrics,
        "device": {},
        "notes": {"sampled": len(samples), "readings": readings, "counters": counters,
                  "buckets": buckets(spans, window), "span_means_ms": span_means(spans, window),
                  "setup_parts_s": parts,
                  **window.notes},
    }
    if device.type == "cuda":
        result["device"] = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                            "count": 1, "memory_peak_bytes": memory_peak}
    if ctx.trace is not None:
        result["device"]["busy_s"] = ctx.trace.busy_s()
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["checks"] = checks
    return result
