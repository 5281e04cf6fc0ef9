"""batch_ms.lidar: host time of one device call of the LiDAR server
(`Detector.detect_batch`: H2D, raster, KFPN, decode, D2H), mean over the
calls that began in the window; the harness's proxy span `device_call`."""


def read(ctx):
    return ctx.spans.mean_ms("device_call", ctx.window.start, ctx.window.end)
