"""Path kind "line": each call draws an origin (lifbench.traffic.Origins:
"origin", optional "strata") and puts its n cameras at origin + span * i
/ n, i = 0 .. n-1 ("span", m per axis). No rotation."""

import numpy as np

from benchmark.lifbench.traffic import Origins


class Path:
    def __init__(self, params: dict, n: int, rng: np.random.Generator):
        self.span = np.asarray(params["span"], np.float64)
        self.n = n
        self.origins = Origins(params, rng)

    def next(self) -> dict:
        i = np.arange(self.n, dtype=np.float64)[:, None]
        return {"position": self.origins.next()[None] + self.span * i / self.n}
