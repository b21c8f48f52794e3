"""The one generator every traffic mix feeds, and the program's cameras.

A traffic mix is a JSON file under traffic/ with these keys:

- "path": {"kind": K, ...}: the poses, drawn by paths/K.py from the
  remaining keys and the seed (see each kind's file);
- "poses_per_call": the cameras of one call;
- "entry": the program's entry point the window drives, entries/<name>.py,
  with optional "entry_kwargs";
- "loop": how calls are offered, loops/<name>.py;
- optionally "trace_seconds", the length of the traced window where the
  whole window's trace would be too large to read.

Poses are a dict of arrays over a call's cameras: "position" (n, 3) in m
and, where a path turns the camera, "rotation" (n, 3, 3).
"""

from __future__ import annotations

import numpy as np

from . import parts


class Origins:
    """Origins drawn from "origin" ([[lo, hi]] * 3, m). With "strata": k
    the ranges are cut into k equal strata and each run of k draws visits
    every stratum once, in a seeded order, at a uniform point inside it:
    every seed gets the same spread, in another order."""

    def __init__(self, params: dict, rng: np.random.Generator):
        self.lo, self.hi = np.asarray(params["origin"], np.float64).T
        self.k = int(params.get("strata", 1))
        self.rng = rng
        self.order = []

    def next(self) -> np.ndarray:
        if not self.order:
            self.order = list(self.rng.permutation(self.k))
        stratum = self.order.pop()
        return self.lo + (self.hi - self.lo) * (
            stratum + self.rng.random(3)) / self.k


class PoseStream:
    """The poses of successive calls of a mix, drawn from `rng`."""

    def __init__(self, traffic: dict, rng: np.random.Generator):
        kind = parts.load("paths", traffic["path"]["kind"])
        self.path = kind.Path(traffic["path"], int(traffic["poses_per_call"]),
                              rng)

    def next(self) -> dict:
        return self.path.next()


def count(poses: dict) -> int:
    return len(poses["position"])


def cameras(lt, poses: dict, config: dict):
    """The program's cameras at `poses`, with the configuration's output
    size and focal."""
    w, h = config["width"], config["height"]
    focal = config["focal_ratio"] * w
    rots = poses.get("rotation")
    return [lt.Camera.create(w, h, focal_px=focal, position=list(p),
                             rotation=None if rots is None else rots[i])
            for i, p in enumerate(poses["position"])]
