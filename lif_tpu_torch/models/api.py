"""Public API: load LIF files into Projectors; convenience rendering.

The counterpart of lif_tpu.models.api, mirroring the reference's exported
surface (reference: src/index.ts:4-19 and loadLifFile,
src/LifLoader.ts:557-673). The loaded projectors' textures live on the
card unless the caller names another device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io import container as _container
from ..io import schema as _schema
from .projector import Projector, projector_from_lif_view

__all__ = ["LifLoader", "LoadLifFileResult", "load_lif_file",
           "orbit_center_from_stereo_data", "synthesize_projector"]


class LifLoader:
    """Stateful loader matching the reference's class shape
    (reference: src/LifLoader.ts:289-377)."""

    def __init__(self):
        self.views = None
        self.stereo_render_data = None
        self.animations = None
        self._meta = None

    def load(self, source) -> dict:
        """Load a LIF file (path, bytes, or file object). Returns the
        normalized metadata dict {views, stereo_render_data?, baseline_mm?}."""
        if isinstance(source, bytes):
            data = source
        elif isinstance(source, str):
            with open(source, "rb") as f:
                data = f.read()
        else:
            data = source.read()
        cont = _container.parse(data)
        meta = _schema.load_meta(cont)
        self._meta = meta
        self.views = meta.get("views")
        self.stereo_render_data = meta.get("stereo_render_data")
        self.animations = meta.get("animations")
        return meta

    def get_views(self):
        if self.views is None:
            raise RuntimeError("Views have not been loaded yet. Call load() first.")
        return self.views

    def get_stereo_render_data(self):
        if self.stereo_render_data is None:
            raise RuntimeError(
                "Stereo render data has not been loaded yet. Call load() first."
            )
        return self.stereo_render_data

    def get_animations(self):
        if self.animations is None:
            raise RuntimeError("Animations have not been loaded yet. Call load() first.")
        return self.animations


@dataclass
class LoadLifFileResult:
    """reference: src/LifLoader.ts:546-550."""

    projectors: list[Projector]
    orbit_center: np.ndarray | None
    stereo_render_data: dict | None
    baseline_meters: float


def orbit_center_from_stereo_data(
    projector: Projector, stereo_data: dict, baseline_meters: float
) -> np.ndarray | None:
    """Orbit centre: the convergence depth (baseline/invd) projected through
    the skewed principal ray, lifted to world space via the projector pose.
    reference: src/LifLoader.ts:589-666."""
    invd = stereo_data.get("invd", stereo_data.get("inv_convergence_distance"))
    if not invd:
        return None

    sk = stereo_data.get("frustum_skew")
    if sk is None:
        sk = {"x": float(projector.skew[0]), "y": float(projector.skew[1])}
    elif not isinstance(sk, dict):
        sk = {"x": sk[0], "y": sk[1]}

    convergence_depth = baseline_meters / invd
    intr = projector.intrinsics
    fx, fy, cx, cy = intr["fx"], intr["fy"], intr["cx"], intr["cy"]

    # pixel through the skewed principal ray: p = c + sk * f
    px = cx + sk["x"] * fx
    py = cy + sk["y"] * fy
    local = np.array(
        [
            (px - cx) * convergence_depth / fx,
            (py - cy) * convergence_depth / fy,
            -convergence_depth,
        ]
    )
    world = np.asarray(projector.rotation, np.float64) @ local + np.asarray(
        projector.position, np.float64
    )
    return world


def load_lif_file(source, device=None) -> LoadLifFileResult:
    """Load a LIF file (path, bytes or file object) and build Projectors
    for every view, their textures on `device` (None: the card).
    reference: src/LifLoader.ts:557-673."""
    loader = LifLoader()
    meta = loader.load(source)

    baseline_mm = meta.get("baseline_mm")
    baseline_meters = baseline_mm / 1000.0 if baseline_mm else 0.063

    projectors = [
        projector_from_lif_view(view, baseline_meters, device=device)
        for view in meta["views"]
    ]

    orbit_center = None
    stereo = meta.get("stereo_render_data")
    if stereo and projectors:
        orbit_center = orbit_center_from_stereo_data(
            projectors[0], stereo, baseline_meters
        )

    return LoadLifFileResult(
        projectors=projectors,
        orbit_center=orbit_center,
        stereo_render_data=stereo,
        baseline_meters=baseline_meters,
    )


def synthesize_projector(projector, position, config=None):
    """Author a geometrically CONSISTENT projector at a new pose: render
    the base projector's novel view and solved depth at ``position`` and
    wrap them as a single-layer Projector there, on the base projector's
    device.

    This is the right way to build a multi-view set from one mono view —
    `dataclasses.replace(projector, position=...)` keeps the same texture
    at a new pose, which describes a DIFFERENT scene (the surface moves
    with the projector).

    Lateral positions only (the depth solver's march reduction). The
    new projector inherits layer 0's focal, invz range and baseline.
    """
    from ..core.camera import Camera
    from .projector import projector_from_arrays
    from .renderer import render_depth_fast, render_fast_view

    izmin = float(projector.invz_min[0])
    izmax = float(projector.invz_max[0])
    cam = Camera.create(
        projector.width, projector.height,
        focal_px=float(projector.focal[0]), position=position,
    )
    # feathering=0: the border taper is a DISPLAY effect; baking it into
    # an authored texture would darken every synthesized projector's
    # edge band even where the source fully covers the view
    rgb = render_fast_view(projector, cam, to_srgb=False, mask_mode="none",
                           feathering=0.0, config=config)[..., :3]
    invz = render_depth_fast(projector, cam, config=config).cpu().numpy()
    disp = np.clip((invz - izmax) / (izmin - izmax), 0.0, 1.0)
    return projector_from_arrays(
        rgb.cpu().numpy(), disp.astype(np.float32),
        focal_px=float(projector.focal[0]),
        invz_min=izmin, invz_max=izmax,
        baseline=float(projector.baseline),
        position=position,
        device=projector.device,
    )
