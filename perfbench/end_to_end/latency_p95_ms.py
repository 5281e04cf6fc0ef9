"""latency_p95_ms: the 95th percentile (nearest rank) over every request due
in the window, each timed from its due time to its reply. A request that
failed or was never answered counts as missing: it takes the tail, and a
run with more than 5% missing reports none."""

import math


def read(ctx):
    reqs = ctx.window.requests
    if not reqs:
        return None
    lat = sorted((r.end - r.start) * 1e3 if (r.error is None and r.end is not None) else math.inf
                 for r in reqs)
    value = lat[math.ceil(0.95 * len(lat)) - 1]
    return value if math.isfinite(value) else None
