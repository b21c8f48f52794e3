"""renderer.host_syncs_per_call (renderer, syncs): the points a call of
the program where the host waited for the card's stream (pageable
uploads, readbacks, synchronizes), the sum of its "sync.*" counters over
its root calls, from lif_tpu_torch.utils.profiling.snapshot() of the
traced window. It serves .batch and .view. None where
renderer.plan_ms_per_call's snapshot() finds nothing to read."""


def read(ctx):
    snap = ctx.load("metrics", "renderer.plan_ms_per_call").snapshot(ctx)
    if snap is None:
        return None
    syncs = sum(n for name, n in snap["counters"].items()
                if name.startswith("sync."))
    return syncs / snap["calls"]
