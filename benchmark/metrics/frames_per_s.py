"""frames_per_s (end to end, frames/s): every frame completed in the
window over the window's whole time, from the first call's start to the
last call's end."""


def read(ctx):
    return ctx.frames / (ctx.records[-1][2] - ctx.t0)
