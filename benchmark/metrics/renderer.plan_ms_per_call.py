"""renderer.plan_ms_per_call (renderer, ms): host milliseconds a call of
the program's planning, the self time of its "lif.plan" spans (pose
routing, the tiers' planners, the plane ladders and their uploads) over
its root calls, from lif_tpu_torch.utils.profiling.snapshot(). The
program records spans only while a profiler records, so the snapshot
covers the traced window alone. It serves every metric split from it by
a last dotted part (renderer.plan_ms_per_call.batch, .view). None where
the trace holds no device activity, where the program has no snapshot,
or where its root calls are not the window's calls (something else was
traced too)."""

import importlib


def snapshot(ctx):
    """The program's span snapshot of the window, or None (see above)."""
    if ctx.trace is None or not ctx.trace.ops:
        return None
    profiling = importlib.import_module("lif_tpu_torch.utils.profiling")
    snap = getattr(profiling, "snapshot", None)
    if snap is None:
        return None
    snap = snap()
    if snap.get("calls") != ctx.calls:
        return None
    return snap


def read(ctx):
    snap = snapshot(ctx)
    if snap is None or "lif.plan" not in snap["spans"]:
        return None
    return snap["spans"]["lif.plan"]["self_ms"] / snap["calls"]
