"""Render-camera model: world pose + pinhole intrinsics + frustum skew.

The counterpart of lif_tpu.core.camera, as a frozen dataclass in place of
a flax struct. Its fields are host numpy: the renderer reads them for
host-side planning only (relative pose, plane tables), never on the
device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Camera", "focal_from_fov", "fov_from_focal", "frustum_corners"]


@dataclasses.dataclass(frozen=True, eq=False)
class Camera:
    """A pinhole render camera (scene convention: -Z forward, +Y up).

    Attributes:
      position: (3,) world position.
      rotation: (3, 3) row-major world rotation (columns = camera axes).
      focal_px: scalar focal length in output pixels (square pixels).
      skew: (2,) frustum-skew tangent angles (sk2); (0, 0) for symmetric
        frustums. reference: RaycastPlane.ts:719-723.
      width/height: output resolution in pixels.
    """

    position: np.ndarray
    rotation: np.ndarray
    focal_px: np.float32
    skew: np.ndarray
    width: int
    height: int

    @classmethod
    def create(
        cls,
        width: int,
        height: int,
        focal_px: float | None = None,
        fov_y_degrees: float | None = None,
        position=(0.0, 0.0, 0.0),
        rotation=None,
        skew=(0.0, 0.0),
    ) -> "Camera":
        if focal_px is None:
            if fov_y_degrees is None:
                raise ValueError("provide focal_px or fov_y_degrees")
            focal_px = focal_from_fov(fov_y_degrees, height)
        if rotation is None:
            rotation = np.eye(3)
        return cls(
            position=np.asarray(position, dtype=np.float32),
            rotation=np.asarray(rotation, dtype=np.float32),
            focal_px=np.float32(focal_px),
            skew=np.asarray(skew, dtype=np.float32),
            width=int(width),
            height=int(height),
        )


def focal_from_fov(fov_y_degrees: float, height: int) -> float:
    """Vertical FOV (degrees) -> focal length in pixels."""
    return (height / 2.0) / np.tan(np.deg2rad(fov_y_degrees) / 2.0)


def fov_from_focal(focal_px: float, height: int) -> float:
    """Focal length in pixels -> vertical FOV in degrees."""
    return float(np.rad2deg(2.0 * np.arctan((height / 2.0) / focal_px)))


def frustum_corners(intrinsics, width, height, invz_min, invz_max,
                    baseline=0.063):
    """8 frustum corner points in projector-local space (near + far
    planes), float64 on the host.

    near = baseline / invz_min, far = baseline / invz_max; corner rays are
    (px - cx)/fx scaled by depth, Z negative (camera looks down -Z).
    reference: src/HoloProjector.ts:388-433.
    Returns (8, 3): rows 0-3 near plane TL,TR,BR,BL; rows 4-7 far plane.
    """
    fx, fy, cx, cy = (intrinsics["fx"], intrinsics["fy"], intrinsics["cx"],
                      intrinsics["cy"])
    near = baseline / invz_min
    far = baseline / invz_max
    corners = np.array([
        [(0 - cx) / fx, (0 - cy) / fy],
        [(width - cx) / fx, (0 - cy) / fy],
        [(width - cx) / fx, (height - cy) / fy],
        [(0 - cx) / fx, (height - cy) / fy],
    ])
    near_pts = np.concatenate([corners * near, np.full((4, 1), -near)], axis=1)
    far_pts = np.concatenate([corners * far, np.full((4, 1), -far)], axis=1)
    return np.concatenate([near_pts, far_pts], axis=0)
