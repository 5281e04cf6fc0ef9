"""Closed loop: `clients` threads, each submitting one request and waiting
for its reply before the next, for the window's length.

Parameters (the traffic file): clients, pool (requests drawn from a pool
of that many, made from the seed). Each client walks its own seeded order
of the pool. A request sent before the close is waited for after it; the
frames of the window are the replies that came before the close. A
quarter of the replies, drawn from the seed, are kept for the check.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from perfbench.harness.window import Request, Window, hold, keep_mask

REPLY_TIMEOUT_S = 120.0
KEEP_SHARE = 0.25
MAX_REQUESTS = 1 << 16  # a client's requests in one window, far above what it sends


def run(system, params: dict, pool: list, seconds: float, seed: int, tracer=None) -> Window:
    clients = int(params["clients"])
    rng = np.random.default_rng([int(seed) % (2 ** 63), 2])
    orders = [rng.permutation(len(pool)) for _ in range(clients)]
    keeps = [keep_mask(seed, i, MAX_REQUESTS, KEEP_SHARE) for i in range(clients)]
    go = threading.Event()
    logs = [[] for _ in range(clients)]
    box = {}

    def client(i: int) -> None:
        go.wait()
        stop_at, log, order, keep = box["end"], logs[i], orders[i], keeps[i]
        k = 0
        while True:
            t = time.perf_counter()
            if t >= stop_at:
                return
            idx = int(order[k % len(order)])
            req = Request(idx, t)
            log.append(req)
            try:
                reply = system.submit(pool[idx]).result(timeout=REPLY_TIMEOUT_S)
                req.end = time.perf_counter()
                if keep[k % MAX_REQUESTS]:
                    req.reply = reply
            except Exception as e:  # a failed request is counted, never raised into the window
                req.error = repr(e)
            k += 1

    threads = [threading.Thread(target=client, args=(i,), name=f"client-{i}") for i in range(clients)]
    for t in threads:
        t.start()
    start = time.perf_counter()
    box["end"] = start + seconds
    go.set()
    hold(start, seconds, tracer)
    for t in threads:
        t.join(timeout=REPLY_TIMEOUT_S + 10)
    alive = sum(t.is_alive() for t in threads)
    window = Window(start, start + seconds, [r for log in logs for r in log])
    window.notes["clients_not_joined"] = alive
    return window
