"""scaled_roofline (kernels, %): target_roofline's reading for the scaled
tier: its work ("scaled_march", costed with data/march_costs.json) over
the device time of every kernel launched by the root calls that rendered
on it (metrics/target_roofline.py says how they are found, and when it
reads nothing)."""


def read(ctx):
    return ctx.load("metrics", "target_roofline").tier_roofline(ctx,
                                                                "scaled")
