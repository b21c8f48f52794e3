"""Path kind "camera-path": one clip a call, its "segments" in their order,
each of "poses" cameras, each drawing its own start a call:

- "kind": "line": a segment of path kind "line" (paths/line.py: an
  origin drawn from "origin" and "strata", then origin + span * i /
  poses), as a lateral slide or a zoom, unrotated;
- "kind": "orbit": yaw theta = theta0 + sweep_deg * i / poses about
  "center" at "radius" (m), theta0 drawn from "theta0_deg" ([lo, hi]
  degrees) in "strata" (lifbench.traffic.Origins): the position center +
  radius * (sin theta, 0, cos theta) and the rotation that looks at the
  centre with +y up (columns: the camera's x, y and z axes, -z forward).

Every call has "rotation" (n, 3, 3), the identity on line segments. The
rotations are worked out here, from the pose alone."""

import numpy as np

from benchmark.lifbench import parts
from benchmark.lifbench.traffic import Origins


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """The rotation of a camera at eye looking at target (-z forward):
    columns x, y, z with z from the target to the eye."""
    z = np.asarray(eye, np.float64) - np.asarray(target, np.float64)
    z = z / np.linalg.norm(z)
    x = np.cross(np.asarray(up, np.float64), z)
    x = x / np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], axis=1)


class Orbit:
    def __init__(self, params: dict, n: int, rng: np.random.Generator):
        self.n = n
        self.theta0 = Origins({"origin": [params["theta0_deg"]] * 3,
                               "strata": params.get("strata", 1)}, rng)
        self.center = np.asarray(params["center"], np.float64)
        self.radius = float(params["radius"])
        self.sweep = float(params["sweep_deg"])

    def next(self) -> dict:
        i = np.arange(self.n, dtype=np.float64)
        theta = np.deg2rad(self.theta0.next()[0] + self.sweep * i / self.n)
        pos = self.center + self.radius * np.stack(
            [np.sin(theta), np.zeros(self.n), np.cos(theta)], axis=1)
        return {"position": pos,
                "rotation": np.stack([look_at(p, self.center) for p in pos])}


class Path:
    def __init__(self, params: dict, n: int, rng: np.random.Generator):
        self.segments = [
            Orbit(s, s["poses"], rng) if s["kind"] == "orbit"
            else parts.load("paths", s["kind"]).Path(s, s["poses"], rng)
            for s in params["segments"]]
        if sum(s["poses"] for s in params["segments"]) != n:
            raise ValueError("the segments' poses do not add up to the "
                             "call's")

    def next(self) -> dict:
        calls = [s.next() for s in self.segments]
        eye = np.eye(3)
        return {
            "position": np.concatenate([c["position"] for c in calls]),
            "rotation": np.concatenate([
                c.get("rotation", np.broadcast_to(eye, (len(c["position"]),
                                                        3, 3)))
                for c in calls]),
        }
