"""march_roofline (kernels, %): the least time the lateral tier's work of
the traced window could take on the card, over the device time of every
kernel the render calls launched. The least time is the larger of the
FP32 operations over the FP32 peak and the bytes over the HBM rate
(data/h100.json). The work is counted by the cell's reference on its own
marches of the sampled frames ("lateral_march": planes visited, pixels,
crossings, source texels, output pixels a frame) and scaled to the
window's frames and calls: each source texel read once a call, each
frame written once. None where the trace holds no kernel or the
reference counted no lateral march."""

import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parents[1] / "data" / "h100.json"


def read(ctx):
    work = ctx.work.get("lateral_march")
    if ctx.trace is None or not work:
        return None
    kernel_s = sum((op.end_ns - op.start_ns) * 1e-9
                   for op in ctx.trace.ops if op.kernel)
    if kernel_s <= 0.0:
        return None
    with open(PEAKS) as f:
        peaks = json.load(f)
    cost, size = peaks["ops"]["lateral_march"], peaks["bytes"]
    n = work["slots"]
    ops = ctx.frames * (cost["per_plane"] * work["planes"]
                        + cost["per_pixel"] * work["pixels"]
                        + cost["per_found"] * work["found"]) / n
    nbytes = (ctx.calls * work["source_texels"] / n * size["source_texel"]
              + ctx.frames * work["out_px"] / n * size["output_pixel"])
    least = max(ops / peaks["fp32_flops_per_s"],
                nbytes / peaks["hbm_bytes_per_s"])
    return 100.0 * least / kernel_s
