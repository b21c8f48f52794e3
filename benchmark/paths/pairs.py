"""Path kind "pairs": stereo pairs of a head that slides. Each call draws
a head origin (lifbench.traffic.Origins: "origin", optional "strata"),
puts its n / 2 heads at origin + span * i / (n / 2), i = 0 .. n/2 - 1
("span", m per axis), and emits each head's left eye, then its right
eye, at the head -/+ "eye_m" on x. No rotation."""

import numpy as np

from benchmark.lifbench.traffic import Origins


class Path:
    def __init__(self, params: dict, n: int, rng: np.random.Generator):
        if n % 2:
            raise ValueError("a call of stereo pairs has an even number of "
                             "cameras")
        self.span = np.asarray(params["span"], np.float64)
        self.eye = np.array([float(params["eye_m"]), 0.0, 0.0])
        self.heads = n // 2
        self.origins = Origins(params, rng)

    def next(self) -> dict:
        i = np.arange(self.heads, dtype=np.float64)[:, None]
        heads = self.origins.next()[None] + self.span * i / self.heads
        eyes = np.stack([heads - self.eye, heads + self.eye], axis=1)
        return {"position": eyes.reshape(-1, 3)}
