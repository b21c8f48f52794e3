"""renderer.launches_per_frame.view (renderer, launches): device
activities (kernels, copies and fills) a frame in the traced window,
counted from the profiler. None where the trace holds none."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return len(ctx.trace.ops) / ctx.frames
