"""pad_share.open: the share of device frames that were padding, padded /
(served + padded), from the server's counters: the waste of running
power-of-two buckets."""


def read(ctx):
    c = ctx.counters
    total = c.get("served", 0) + c.get("padded", 0)
    return 100.0 * c["padded"] / total if total else None
