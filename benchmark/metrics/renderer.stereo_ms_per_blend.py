"""renderer.stereo_ms_per_blend (renderer, ms): host milliseconds of the
program's stereo mechanism for each layer it blended across both eyes in
a pose chunk: the self time of its "lif.stereo.*" spans (each eye's
stretch-mark confidence, "lif.stereo.conf", and the occlusion fill and
blend, "lif.stereo.blend") over its "stereo.blend" counter (once a layer
of a chunk), both from lif_tpu_torch.utils.profiling.snapshot() of the
traced window. The self time takes in the host's waits on the stream for
_stretch_conf's pose uploads, which renderer.host_syncs_per_call counts.
None where renderer.plan_ms_per_call's snapshot() finds nothing to read,
or where the program counts no stereo.blend."""


def read(ctx):
    snap = ctx.load("metrics", "renderer.plan_ms_per_call").snapshot(ctx)
    if snap is None:
        return None
    blends = snap["counters"].get("stereo.blend", 0)
    if not blends:
        return None
    return sum(s["self_ms"] for name, s in snap["spans"].items()
               if name.startswith("lif.stereo.")) / blends
