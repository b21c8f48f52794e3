"""Reference "camera-path": each sampled frame of a camera-path clip held
against the plain reference of the tier its segment renders on.

options["segments"] lists the clip's runs in order as [tier, poses], the
runs of entries/render_camera_path.py: "lateral" (reference/lateral.py,
its ladder sized over the segment's x positions, as the program sizes it
for a call), "target" (reference/target.py) or "scaled"
(reference/scaled.py), each given its segment's poses alone. render_slot
returns the frame and the work of its march under "<tier>_march", with
the segment's pose count under "poses".

The target and scaled references freeze the RenderConfig knobs of their
ladders (FROZEN); a configuration whose render_config states another
value of one is refused."""

from __future__ import annotations

import numpy as np
import torch

from . import lateral, scaled, target

TIERS = {"target": target.render, "scaled": scaled.render}
FROZEN = {"target_step_px": target.STEP_PX, "target_refine": 0,
          "rotated_step_px": scaled.STEP_PX, "rotated_refine": scaled.REFINE}


def segment_of(j, segments):
    """(tier, first camera, poses) of the segment holding camera j."""
    a = 0
    for tier, n in segments:
        if j < a + n:
            return tier, a, n
        a += n
    raise ValueError(f"camera {j} lies past the clip's segments")


def render_slot(srcs, slot, config, options, dtype=torch.float32):
    """The reference of one sampled frame (slot: its frame, its index j in
    the call and the call's poses) and the work of its march."""
    if len(srcs) != 1:
        raise ValueError("the camera-path reference takes one projector")
    rc = config["render_config"]
    for key, value in FROZEN.items():
        if rc.get(key, value) != value:
            raise ValueError(f"the camera-path reference marches at "
                             f"{key} {value}, not {rc[key]}")
    tier, a, n = segment_of(slot.j, options["segments"])
    pos = np.asarray(slot.poses["position"], np.float64)[a:a + n]
    rot = np.asarray(slot.poses["rotation"], np.float64)[a:a + n]
    if tier == "lateral":
        frame, work = lateral.render_slot(
            srcs, slot._replace(j=slot.j - a, poses={"position": pos,
                                                     "rotation": rot}),
            config, {"ladder": "call"}, dtype)
        work = work["lateral_march"]
    else:
        frame, work = TIERS[tier](srcs[0], slot.j - a, pos, rot, config,
                                  dtype)
    return frame, {f"{tier}_march": dict(work, poses=n)}
