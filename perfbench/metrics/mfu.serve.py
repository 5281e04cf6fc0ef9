"""mfu.serve: the served networks' FLOPs (counts/<each counted model>.py)
over the traced sub-window, against the card's float32 peak (67 TFLOP/s:
the configurations state float32 with TF32 off)."""

from perfbench.harness import readers


def read(ctx):
    per_frame = sum(ctx.counts(m).flops_per_frame(ctx.config) for m in ctx.config["counted_models"])
    return readers.mfu(ctx, per_frame)
