"""The output check: a stratified sample of the timed path's frames,
held against the cell's plain reference (checks/<cell>.json names it).

Numbers compared, each over every channel of every sampled frame (sRGB
RGBA in [0, 1]):

- max_gap: the widest absolute gap;
- mean_gap: the mean absolute gap;
- mismatch_share: the share of pixels with a gap above 1/255 in any
  channel.

A limit of null in a cell's check file leaves a number printed but not
held.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

MISMATCH = 1.0 / 255.0


class Slot(NamedTuple):
    """A sampled frame: the frame, its index j in its call and the call's
    poses (lifbench.traffic)."""
    frame: torch.Tensor
    j: int
    poses: dict


class Reservoir:
    """A seeded sample of the frames offered, stratified.

    strata: {"slot": b} cuts each call's cameras into b equal runs by
    their index in the call (each run of 2*n/b - 1 or more cameras, such
    as one pose chunk or one camera of a rig, then holds a whole one);
    {"x": [lo, hi, b]} cuts the camera's |x| into b bins; both give b*b'
    strata. ceil(k / strata) frames are drawn uniformly from each
    stratum's frames, so every seed samples every part of the call and
    of the path."""

    def __init__(self, k: int, rng: np.random.Generator, strata=None):
        strata = strata or {}
        self.rng = rng
        self.slot_bins = int(strata.get("slot", 1))
        self.x = strata.get("x")
        x_bins = int(self.x[2]) if self.x else 1
        self.k = -(-k // (self.slot_bins * x_bins))
        self.bins = {}

    @property
    def slots(self):
        return [s for key in sorted(self.bins) for s in self.bins[key][1]]

    def key(self, j: int, n: int, x: float):
        xb = 0
        if self.x:
            lo, hi, nb = self.x
            xb = min(nb - 1, max(0, int((abs(x) - lo) * nb / (hi - lo))))
        return j * self.slot_bins // n, xb

    def offer(self, frames, poses):
        pos = poses["position"]
        n = len(pos)
        for j in range(n):
            entry = self.bins.setdefault(self.key(j, n, float(pos[j][0])),
                                         [0, []])
            seen, kept = entry
            if len(kept) < self.k:
                kept.append(Slot(frames[j].clone(), j, poses))
            else:
                r = int(self.rng.integers(0, seen + 1))
                if r < self.k:
                    kept[r] = Slot(frames[j].clone(), j, poses)
            entry[0] = seen + 1


def gaps(pairs):
    """The numbers compared, over (frame, reference) pairs."""
    worst, total, n, bad, px = 0.0, 0.0, 0, 0, 0
    if not pairs:
        raise RuntimeError("the window gave no frame to check")
    for frame, ref in pairs:
        gap = (frame.float() - ref.float()).abs()
        gap = torch.nan_to_num(gap, nan=math.inf)
        worst = max(worst, float(gap.max()))
        total += float(gap.double().sum())
        n += gap.numel()
        bad += int((gap.amax(-1) > MISMATCH).sum())
        px += gap[..., 0].numel()
    return {"max_gap": worst, "mean_gap": total / n,
            "mismatch_share": bad / px}


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """(correct, [(name, value, limit)]) over the held numbers."""
    rows = [(k, numbers[k], limits.get(k)) for k in sorted(numbers)]
    ok = all(math.isfinite(v) for _, v, _ in rows) and all(
        v <= lim for _, v, lim in rows if lim is not None)
    return ok, rows
