"""setup_s (end to end, s): process start to the first timed call: the
imports and CUDA context, the program's kernels loaded or built, the
scene made on the card and the warm-up calls."""


def read(ctx):
    return ctx.setup_s
