"""psnr_db (end to end, dB): PSNR of the pooled RGB error, peak 1, of
the window's sampled frames against the cell's exact reference (the
module under reference/ that checks/<cell>.json names under "exact").
None where the cell names none."""

import math


def read(ctx):
    name = ctx.cell.check.get("exact")
    if not name or not ctx.slots:
        return None
    exact = ctx.load("reference", name)
    sq, n = 0.0, 0
    for slot in ctx.slots:
        ref = exact.render_slot(ctx.srcs, slot, ctx.cell.config)
        d = slot.frame[..., :3].double() - ref[..., :3].double()
        sq += float((d * d).sum())
        n += d.numel()
        del ref, d
    return 10.0 * math.log10(1.0 / max(sq / n, 1e-20))
