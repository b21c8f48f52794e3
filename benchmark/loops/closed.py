"""Loop "closed": one caller, each call offered when the previous one has
finished and synchronized, until `seconds` have passed since the first
started. A record is (due, start, end, frames); a closed loop's call is
due when it starts."""

import time


def run(call, stream, seconds, sync, offer, span):
    """(t0, records) of the window."""
    records = []
    t0 = time.perf_counter()
    while True:
        poses = stream.next()
        with span():
            ts = time.perf_counter()
            frames = call(poses)
            sync()
            te = time.perf_counter()
        offer(frames, poses)
        n = frames.shape[0]
        del frames
        records.append((ts, ts, te, n))
        if te - t0 >= seconds:
            return t0, records
