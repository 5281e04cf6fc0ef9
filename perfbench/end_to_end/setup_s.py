"""setup_s: process start to the first request of the window, in seconds:
imports, the card's context, weights, the program's build or load of its
kernels, the request pool and the warm-up."""


def read(ctx):
    return ctx.setup_s
