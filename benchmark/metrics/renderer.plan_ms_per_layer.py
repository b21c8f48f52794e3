"""renderer.plan_ms_per_layer (renderer, ms): host milliseconds of the
program's planning for each layer it planned on the lateral march: the
self time of its "lif.plan" spans over its "plan.march_layer" counter
(once a layer in _plan_march_layer), both from
lif_tpu_torch.utils.profiling.snapshot() of the traced window; that is,
lif.plan ms a call over the march layers planned a call. It serves every
metric split from it by a last dotted part (.ldi). None where
renderer.plan_ms_per_call's snapshot() finds nothing to read, or where
the program counts no plan.march_layer."""


def read(ctx):
    snap = ctx.load("metrics", "renderer.plan_ms_per_call").snapshot(ctx)
    if snap is None or "lif.plan" not in snap["spans"]:
        return None
    layers = snap["counters"].get("plan.march_layer", 0)
    if not layers:
        return None
    return snap["spans"]["lif.plan"]["self_ms"] / layers
