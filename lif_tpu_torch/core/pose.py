"""Pose math: LIF rotation encoding, quaternions, world<->camera
transforms and orbit poses (float64 numpy).

Host-side numpy, a copy of lif_tpu.core.pose (the JAX package's version
is already numpy; it is copied, not imported, because importing lif_tpu
pulls in jax).

reference semantics:
  * LIF rotation -> quaternion: reference src/LifLoader.ts:13-94
  * world -> camera-local projector pose (with Z negation):
    reference src/RaycastPlane.ts:597-676
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "quat_from_axis_angle",
    "quat_multiply",
    "quat_to_matrix",
    "lif_rotation_to_quaternion",
    "lif_rotation_to_matrix",
    "relative_view_pose",
    "look_at_rotation",
    "orbit_pose",
]


def quat_from_axis_angle(axis, angle) -> np.ndarray:
    """Quaternion (x, y, z, w) for a rotation of `angle` radians about `axis`."""
    axis = np.asarray(axis, dtype=np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-12:
        return np.array([0.0, 0.0, 0.0, 1.0])
    axis = axis / n
    half = 0.5 * float(angle)
    s = np.sin(half)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, np.cos(half)])


def quat_multiply(a, b) -> np.ndarray:
    """Hamilton product a*b, both (x, y, z, w)."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ]
    )


def quat_to_matrix(q) -> np.ndarray:
    """Row-major rotation matrix from quaternion (x, y, z, w)."""
    x, y, z, w = np.asarray(q, dtype=np.float64)
    n = x * x + y * y + z * z + w * w
    s = 0.0 if n < 1e-12 else 2.0 / n
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    return np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1.0 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1.0 - (xx + yy)],
        ]
    )


def lif_rotation_to_quaternion(rotation) -> np.ndarray:
    """Convert a LIF rotation encoding to a scene quaternion (x, y, z, w).

    Accepts the legacy array form ``[sl_x, sl_y, roll_radians]`` or the dict
    form ``{"rotation_slant": {"x", "y"}, "roll_degrees": ...}``.

    LIF encodes the view direction as forward = normalize(sl_x, sl_y, 1)
    (+Z forward); the scene convention is -Z forward, so the Z component is
    negated. Roll is then applied about the (scene) forward axis.
    reference: src/LifLoader.ts:13-94.
    """
    if isinstance(rotation, dict):
        if "rotation_slant" in rotation:
            slant = rotation["rotation_slant"] or {}
            sl_x = float(slant.get("x", 0.0))
            sl_y = float(slant.get("y", 0.0))
            roll = float(rotation.get("roll_degrees", 0.0)) * np.pi / 180.0
        else:
            sl_x = float(rotation.get("x", rotation.get(0, 0.0)))
            sl_y = float(rotation.get("y", rotation.get(1, 0.0)))
            roll = float(rotation.get("roll", rotation.get(2, 0.0)))
    else:
        sl_x, sl_y, roll = (float(v) for v in rotation)

    forward = np.array([sl_x, sl_y, -1.0])  # Z negated: LIF +Z -> scene -Z
    forward = forward / np.linalg.norm(forward)
    default_forward = np.array([0.0, 0.0, -1.0])

    axis = np.cross(default_forward, forward)
    cos_angle = np.clip(np.dot(default_forward, forward), -1.0, 1.0)
    angle = np.arccos(cos_angle)

    if np.dot(axis, axis) < 1e-4:
        if forward[2] > 0:  # pointing at +Z: 180 deg about Y
            q = quat_from_axis_angle([0.0, 1.0, 0.0], np.pi)
        else:
            q = np.array([0.0, 0.0, 0.0, 1.0])
    else:
        q = quat_from_axis_angle(axis, angle)

    roll_q = quat_from_axis_angle(forward, roll)
    return quat_multiply(roll_q, q)  # premultiply roll


def lif_rotation_to_matrix(rotation) -> np.ndarray:
    """Rotation matrix form of :func:`lif_rotation_to_quaternion`."""
    return quat_to_matrix(lif_rotation_to_quaternion(rotation))


def relative_view_pose(view_position, view_rotation, cam_position, cam_rotation):
    """Express a projector pose in the render camera's local frame.

    Returns ``(position, rotation)`` where position has its Z negated (the
    shader works in a +Z-forward frame) and rotation is ``R_cam^T @ R_view``.
    reference: src/RaycastPlane.ts:607-635 (position via camera
    matrixWorldInverse then Z-flip; rotation via Matrix3(camInv) * Matrix3(view)).
    """
    view_position = np.asarray(view_position, dtype=np.float64)
    view_rotation = np.asarray(view_rotation, dtype=np.float64)
    cam_position = np.asarray(cam_position, dtype=np.float64)
    cam_rotation = np.asarray(cam_rotation, dtype=np.float64)

    pos_local = cam_rotation.T @ (view_position - cam_position)
    pos_shader = pos_local * np.array([1.0, 1.0, -1.0])
    rot_local = cam_rotation.T @ view_rotation
    return pos_shader, rot_local


def look_at_rotation(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """Rotation matrix for a camera at `eye` looking at `target` (-Z forward)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    z = eye - target  # camera -Z forward => +Z points away from target
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    xn = np.linalg.norm(x)
    if xn < 1e-9:  # up parallel to view dir
        x = np.array([1.0, 0.0, 0.0])
    else:
        x = x / xn
    y = np.cross(z, x)
    return np.stack([x, y, z], axis=1)


def orbit_pose(center, radius, theta, phi=0.0, up=(0.0, 1.0, 0.0)):
    """Camera pose orbiting `center` at `radius`; theta = azimuth, phi = elevation.

    Matches the demo's spherical orbit controls (reference index.html:1271-1313).
    Returns (position, rotation).
    """
    center = np.asarray(center, dtype=np.float64)
    ct, st = np.cos(theta), np.sin(theta)
    cp, sp = np.cos(phi), np.sin(phi)
    offset = radius * np.array([st * cp, sp, ct * cp])
    position = center + offset
    return position, look_at_rotation(position, center, up)
