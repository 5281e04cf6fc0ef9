"""Open loop: requests due on a schedule, sent whether or not earlier ones
have been answered.

Parameters (the traffic file): rate_per_s, senders, pool. The window holds
round(rate x seconds) requests. Their gaps are one fixed set of
exponential draws (Poisson arrivals at the rate), scaled so that they
fill the window, and the run's seed only orders them and picks each
request's scan: every seed offers the same load. `senders` threads share
the sending (request k goes to thread k mod senders); each sleeps to its
request's due time. A request is timed from its due time, so a late sender
shows in the latency. After the close every reply is waited for. A
quarter of the replies, drawn from the seed, are kept for the check.
"""

from __future__ import annotations

import threading
import time
import numpy as np

from perfbench.harness.window import Request, Window, hold, keep_mask

ARRIVALS_SEED = 20260
DRAIN_S = 60.0
KEEP_SHARE = 0.25


def schedule(rate: float, seconds: float, seed: int) -> np.ndarray:
    """Due times in [0, seconds), relative to the window's start."""
    n = max(1, int(round(rate * seconds)))
    gaps = np.random.default_rng(ARRIVALS_SEED).exponential(1.0, n)
    gaps = gaps[np.random.default_rng([int(seed) % (2 ** 63), 3]).permutation(n)]
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    return due * (seconds / gaps.sum())


def run(system, params: dict, pool: list, seconds: float, seed: int, tracer=None) -> Window:
    due = schedule(float(params["rate_per_s"]), seconds, seed)
    picks = np.random.default_rng([int(seed) % (2 ** 63), 4]).integers(0, len(pool), len(due))
    senders = int(params["senders"])
    reqs = [Request(int(p), 0.0) for p in picks]
    keep = keep_mask(seed, 0, len(due), KEEP_SHARE)
    late = [0.0] * senders
    go = threading.Event()
    box = {}
    lock = threading.Lock()
    outstanding = [len(due)]
    all_done = threading.Event()

    def settle():
        with lock:
            outstanding[0] -= 1
            if outstanding[0] == 0:
                all_done.set()

    def on_reply(k):
        def done(fut):
            req = reqs[k]
            req.end = time.perf_counter()
            if fut.cancelled() or fut.exception() is not None:
                req.error = "cancelled" if fut.cancelled() else repr(fut.exception())
            elif keep[k]:
                req.reply = fut.result()
            settle()
        return done

    def sender(j: int) -> None:
        go.wait()
        start = box["start"]
        for k in range(j, len(due), senders):
            t_due = start + due[k]
            left = t_due - time.perf_counter()
            if left > 0:
                time.sleep(left)
            req = reqs[k]
            req.start = t_due
            late[j] = max(late[j], time.perf_counter() - t_due)
            try:
                system.submit(pool[req.pool_index]).add_done_callback(on_reply(k))
            except Exception as e:  # a refused request is counted as missing
                req.error = repr(e)
                settle()

    threads = [threading.Thread(target=sender, args=(j,), name=f"sender-{j}") for j in range(senders)]
    for t in threads:
        t.start()
    start = time.perf_counter() + 0.01
    box["start"] = start
    go.set()
    hold(start, seconds, tracer)
    for t in threads:
        t.join(timeout=DRAIN_S)
    all_done.wait(timeout=DRAIN_S)
    with lock:
        for req in reqs:
            if req.end is None and req.error is None:
                req.error = "not answered within the drain"
    window = Window(start, start + seconds, reqs)
    window.notes["sender_late_max_ms"] = max(late) * 1e3
    return window
