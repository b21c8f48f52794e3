"""Path kind "sweep": one camera a call, going back and forth across
+-"bound" (m per axis). It starts at an origin drawn by
lifbench.traffic.Origins, moving in a seeded direction, and each call
moves it by a step drawn uniformly in ["step_min", "step_max"] (m per
axis), turning at the bounds. No rotation."""

import numpy as np

from benchmark.lifbench.traffic import Origins


class Path:
    def __init__(self, params: dict, n: int, rng: np.random.Generator):
        if n != 1:
            raise ValueError("a sweep moves one camera a call")
        self.lo, self.hi = (np.asarray(params[k], np.float64)
                            for k in ("step_min", "step_max"))
        self.bound = np.asarray(params["bound"], np.float64)
        self.rng = rng
        self.heading = np.where(rng.random(3) < 0.5, -1.0, 1.0)
        self.origins = Origins(params, rng)
        self.last = None

    def next(self) -> dict:
        if self.last is None:
            pos = self.origins.next()
        else:
            pos = self.last + self.heading * (
                self.lo + (self.hi - self.lo) * self.rng.random(3))
            # turn at +-bound
            over = np.abs(pos) > self.bound
            pos = np.where(over, np.sign(pos) * 2 * self.bound - pos, pos)
            self.heading = np.where(over, -self.heading, self.heading)
        self.last = pos
        return {"position": pos[None]}
