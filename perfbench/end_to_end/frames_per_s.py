"""frames_per_s: frames answered inside the window, over the window's
seconds (host clock). A frame answered after the close does not count."""


def read(ctx):
    w = ctx.window
    done = sum(1 for r in w.answered() if r.end <= w.end)
    return done / w.seconds
