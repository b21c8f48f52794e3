"""device.idle_share (device, %): the share of the traced window in which
no kernel, copy or fill ran on the card: 1 - (union of the device
activities' intervals) / (the window from the first call's start to the
last call's end). It serves every metric split from it by a last dotted
part (device.idle_share.batch, device.idle_share.view). None where the
trace holds no device activity."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
