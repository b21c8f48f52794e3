"""frame_ms_p95 (end to end, ms): the 95th percentile, over every frame
of the window, of the time from a call being due to its frames being
ready on the card (synchronized), shared by the call's frames. Python's
inclusive quantiles."""

import statistics


def read(ctx):
    values = [(end - due) * 1e3 / n for due, _, end, n in ctx.records]
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]
