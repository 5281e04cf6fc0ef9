"""Arithmetic the per-layer readers share: the device's idle share in the
traced sub-window, the whole step's share of the float32 peak, and a
kernel's share of its bound. A reader that finds nothing returns None."""

from perfbench.harness import peaks


def device_idle(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)


def mfu(ctx, flops_per_frame: float):
    """Frames of the device calls inside the traced sub-window (a call on
    its edge by the share of it inside) x FLOPs a frame, over the
    sub-window's seconds, against the float32 peak."""
    t = ctx.trace
    if t is None:
        return None
    frames = sum(s[3]["frames"] * share for s, share in ctx.spans_in_trace("device_call"))
    if frames <= 0:
        return None
    return 100.0 * frames * flops_per_frame / (t.window_s * peaks.FP32_FLOPS)


def mean_bucket(ctx):
    calls = ctx.spans_in_trace("device_call")
    return sum(s[3]["bucket"] for s, _ in calls) / len(calls) if calls else None
