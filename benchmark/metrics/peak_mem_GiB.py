"""peak_mem_GiB (end to end, GiB): torch.cuda.max_memory_allocated() over
the window (reset after the warm-up). None off the card."""


def read(ctx):
    if ctx.window_peak is None:
        return None
    return ctx.window_peak / 2**30
