"""bev_raster_reduce_roofline: the raster reduce kernel's bound (its bytes,
counts/bev_raster_reduce.py, at the card's memory rate) over its device
time, in %, summed over the launches that began in the traced sub-window.
The launches' batch is that of the device calls over the sub-window."""

from perfbench.harness import peaks, readers


KERNEL = r"bev_tile_kernel"


def read(ctx):
    t = ctx.trace
    launches = t.kernels(KERNEL) if t is not None else []
    bucket = readers.mean_bucket(ctx)
    if not launches or bucket is None:
        return None
    cfg = ctx.config
    per_launch = ctx.counts("bev_raster_reduce").bytes_moved(bucket, cfg["max_points"], cfg["bev_height"], cfg["bev_width"])
    device_s = sum(e - s for _, s, e in launches)
    return 100.0 * len(launches) * per_launch / peaks.HBM_BYTES_PER_S / device_s
