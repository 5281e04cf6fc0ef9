"""batch_frames.open: requests a device batch carried, served / batches,
from the batching server's own counters (`runtime/serving.py` stats) over
the window and its drain."""


def read(ctx):
    c = ctx.counters
    return c["served"] / c["batches"] if c.get("batches") else None
