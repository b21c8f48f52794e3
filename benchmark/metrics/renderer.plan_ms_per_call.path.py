"""renderer.plan_ms_per_call.path (renderer, ms): host milliseconds a
window call (a clip) of the program's planning: the self time of its
"lif.plan" spans and of the spans nested in them under "lif.plan." (the
target and scaled tiers' planners), from
lif_tpu_torch.utils.profiling.snapshot(), over the window's calls. A
clip is one root call a segment of the entry's "segments"
(entries/render_camera_path.py). None where the trace holds no device
activity, where the program has no snapshot, or where its root calls are
not the window's segments (something else was traced too)."""

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
    segments = len(ctx.cell.traffic["entry_kwargs"]["segments"])
    if snap.get("calls") != ctx.calls * segments:
        return None
    return snap


def read(ctx):
    snap = snapshot(ctx)
    if snap is None or "lif.plan" not in snap["spans"]:
        return None
    return sum(s["self_ms"] for name, s in snap["spans"].items()
               if name == "lif.plan" or name.startswith("lif.plan.")
               ) / ctx.calls
