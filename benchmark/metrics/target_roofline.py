"""target_roofline (kernels, %): the least time the target tier's work of
the traced window could take on the card, over the device time of every
kernel launched by the root calls that rendered on that tier. The least
time is the larger of the FP32 operations over the FP32 peak and the
bytes over the HBM rate (data/h100.json). The work is counted by the
cell's reference on its own marches of the sampled frames
("target_march": planes visited from the start plane, pixels, crossings,
source texels and output pixels a frame, the segment's poses), costed
with data/march_costs.json, and scaled to the tier's root calls of the
window: each source texel read once a call, each frame written once.
tier_roofline serves scaled_roofline too.

A root call's kernels are found in the device trace's order: the clip
entry copies each segment's frames into its clip with one
device-to-device copy right after the segment's call, so each root call's
device activity ends at a "Memcpy DtoD" that lasts at least as long as
copying the smallest segment's frames could (their bytes read and
written at the HBM rate: the program's own device-to-device copies move
small tables, the harness's sample a frame or two); a root call
rendered on the tier where it launched the tier's kernel. None where the
trace holds no kernel, the reference counted no such march, the program
counted no route.<tier>, or the trace does not bear the reading out (as
many clip copies as root calls, as many root calls with the tier's
kernel as route.<tier> counted)."""

import json
from pathlib import Path

DATA = Path(__file__).resolve().parents[1] / "data"
COPY = "Memcpy DtoD"


def root_calls(ops, copy_ns):
    """The window's device activities in the device's order, cut after
    each device-to-device copy of copy_ns or longer: (one list a root
    call, the activities after the last cut)."""
    calls, cur = [], []
    for op in sorted(ops, key=lambda o: o.start_ns):
        cur.append(op)
        if op.name.startswith(COPY) and op.end_ns - op.start_ns >= copy_ns:
            calls.append(cur)
            cur = []
    return calls, cur


def tier_roofline(ctx, tier):
    work = ctx.work.get(f"{tier}_march")
    if ctx.trace is None or not ctx.trace.ops or not work:
        return None
    snap = ctx.load("metrics", "renderer.plan_ms_per_call.path").snapshot(ctx)
    if snap is None:
        return None
    routed = snap["counters"].get(f"route.{tier}", 0)
    with open(DATA / "march_costs.json") as f:
        cost = json.load(f)[f"{tier}_march"]
    with open(DATA / "h100.json") as f:
        peaks = json.load(f)
    size = peaks["bytes"]
    n = work["slots"]
    segment = min(ctx.cell.traffic["entry_kwargs"]["segments"])
    copy_ns = (2e9 * segment * work["out_px"] / n * size["output_pixel"]
               / peaks["hbm_bytes_per_s"])
    calls, rest = root_calls(ctx.trace.ops, copy_ns)
    mine = [c for c in calls if any(cost["kernel"] in op.name for op in c)]
    if (not routed or rest or len(calls) != snap["calls"]
            or len(mine) != routed):
        return None
    kernel_s = sum((op.end_ns - op.start_ns) * 1e-9
                   for c in mine for op in c if op.kernel)
    frames = routed * work["poses"] / n
    ops = frames * (cost["per_plane"] * work["planes"]
                    + cost["per_pixel"] * work["pixels"]
                    + cost["per_found"] * work["found"]) / n
    nbytes = (routed * work["source_texels"] / n * size["source_texel"]
              + frames * work["out_px"] / n * size["output_pixel"])
    least = max(ops / peaks["fp32_flops_per_s"],
                nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * least / kernel_s


def read(ctx):
    return tier_roofline(ctx, "target")
