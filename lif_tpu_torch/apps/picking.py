"""Ray picking against a projector's depth surface.

The counterpart of lif_tpu.apps.picking. The demo implements picking
twice on the CPU, a canvas-readback march for the mouse (reference:
index.html:791-942) and a finer variant for VR controllers
(index.html:952-1180), duplicating the shader's math. Here it is the
renderer's own march (ops.raycast.raycast_layer) evaluated on a 1x1 pixel
grid: the march's refined inverse depth gives the surface point.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.camera import Camera
from ..core.pose import relative_view_pose
from ..core.transforms import inv3, mat_from_focal, mm
from ..models.projector import Projector
from ..ops import raycast as _raycast

__all__ = ["PickResult", "pick"]

_F32 = np.float32


@dataclass
class PickResult:
    """Matches the reference's ControllerHitInfo fields
    (reference: types/controller.d.ts:7-25, index.html:1163-1174)."""

    hit: bool
    point: np.ndarray | None  # world-space hit point
    uv: np.ndarray | None  # [0,1]^2 source-texture coordinates
    layer: int
    distance: float
    inv_z: float


def pick(
    projector: Projector,
    camera: Camera,
    pixel_x: float,
    pixel_y: float,
    num_steps: int = 100,
) -> PickResult:
    """Cast one ray through output pixel (pixel_x, pixel_y) (top-down pixel
    coordinates, like the demo's mouse events) and intersect the
    projector's depth surface.

    Marches the layers front to back and returns the first hit whose
    alpha exceeds 0.5, in the renderer's compositing order. The demo uses
    100 coarse steps + bisection (index.html:871-875); the march's
    step-halving refinement is the same search, so num_steps=100
    reproduces that precision. The march runs on the projector's device;
    the result is host numbers."""
    pos, rot = relative_view_pose(projector.position, projector.rotation,
                                  camera.position, camera.rotation)
    baseline = float(projector.baseline)
    device = projector.device

    # s2 for this pixel, the top-down y turned GL-oriented
    u = (pixel_x + 0.5) / camera.width - 0.5
    v = (camera.height - 1 - pixel_y + 0.5) / camera.height - 0.5
    s2x = torch.full((1, 1), float(_F32(u)), device=device)
    s2y = torch.full((1, 1), float(_F32(v)), device=device)

    skr1 = _raycast.build_skr1(projector.skew, np.asarray(rot, np.float32))
    fskr2 = _raycast.build_fskr2(float(camera.focal_px), float(camera.width),
                                 float(camera.height), camera.skew)
    c_rel = -torch.as_tensor(np.asarray(pos, np.float32))
    mask_mode = "multiply" if projector.num_layers > 1 else "none"
    for layer in range(projector.num_layers):
        res_w = float(projector.layer_res[layer, 0])
        res_h = float(projector.layer_res[layer, 1])
        focal = float(projector.focal[layer])
        fskr1 = mm(mat_from_focal(_F32(focal / res_w), _F32(focal / res_h)),
                   skr1)
        rgba, invz2, _ = _raycast.raycast_layer(
            s2x, s2y, mm(fskr1, inv3(fskr2)), fskr1 @ c_rel,
            projector.rgb[layer], projector.disp[layer],
            projector.mask[layer],
            float(projector.invz_min[layer]) / baseline,
            float(projector.invz_max[layer]) / baseline, res_w, res_h,
            torch.zeros(3, device=device), 0.0, num_steps=num_steps,
            mask_mode=mask_mode,
        )
        alpha = float(rgba[0, 0, 3])
        iz2 = float(invz2[0, 0])
        if alpha > 0.5 and iz2 > 0.0:
            # invz2 is in absolute 1/m (the march ran on the
            # baseline-normalized range): camera-local depth 1 / invz2
            depth = 1.0 / iz2
            dx = u * camera.width / float(camera.focal_px)
            dy = v * camera.height / float(camera.focal_px)
            p_cam = np.array([dx * depth, dy * depth, -depth])
            world = (np.asarray(camera.rotation, np.float64) @ p_cam
                     + np.asarray(camera.position, np.float64))
            # the hit's source uv: the world point projected into the
            # projector
            local = np.asarray(projector.rotation, np.float64).T @ (
                world - np.asarray(projector.position, np.float64))
            intr = projector.intrinsics
            px = intr["fx"] * (local[0] / -local[2]) + intr["cx"]
            py_td = intr["fy"] * (-local[1] / -local[2]) + intr["cy"]
            uv = np.array([px / projector.width, py_td / projector.height])
            return PickResult(
                hit=True, point=world, uv=uv, layer=layer,
                distance=float(np.linalg.norm(
                    world - np.asarray(camera.position))),
                inv_z=iz2,
            )
    return PickResult(False, None, None, -1, float("inf"), 0.0)
