"""Scene containers: LayerGroup and Scene.

The counterpart of lif_tpu.models.scene (copied: the port imports nothing
of lif_tpu). The reference's HoloLayerGroup spawns one HoloRenderer per
LDI layer with renderOrder = layer index (reference:
src/HoloLayerGroup.ts:35-66). Here the Projector already carries its
layer stack as stacked tensors and the renderers composite front-to-back
in one pass, so LayerGroup is
the scene-level convenience wrapper: render-mode management, per-group
settings, and stats — the same public knobs as the reference
(HoloLayerGroup.ts:72-162).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal

from .projector import Projector
from .renderer import render

__all__ = ["LayerGroup", "Scene"]


@dataclass
class LayerGroup:
    """Multi-layer rendering group for one projector.

    Auto mode selection matches the reference: 1 layer -> 'mesh',
    >1 -> 'raycast' (HoloLayerGroup.ts:42).
    """

    projector: Projector
    render_mode: Literal["mesh", "raycast"] | None = None
    gradient_threshold: float = 0.0  # deltaInvZThreshold (HoloRenderer.ts:134)
    show_depth: bool = False
    feathering: float = 0.1
    background: tuple = (0.0, 0.0, 0.0, 0.0)

    def __post_init__(self):
        if self.render_mode is None:
            self.render_mode = "mesh" if self.projector.num_layers == 1 else "raycast"

    def set_render_mode(self, mode: Literal["mesh", "raycast"]) -> None:
        """reference: HoloLayerGroup.ts:80-96."""
        self.render_mode = mode

    def set_gradient_threshold(self, threshold: float) -> None:
        """reference: HoloLayerGroup.ts:126-139 / HoloRenderer.ts:894-896."""
        self.gradient_threshold = float(threshold)

    def toggle_depth_visualization(self) -> bool:
        """reference: HoloLayerGroup.ts:141-151."""
        self.show_depth = not self.show_depth
        return self.show_depth

    def get_stats(self) -> dict:
        """reference: HoloLayerGroup.ts:106-121."""
        p = self.projector
        return {
            "layer_count": p.num_layers,
            "render_mode": self.render_mode,
            "total_pixels": int(p.num_layers * p.width * p.height),
            "layers": [
                {
                    "width": int(p.layer_res[i, 0]),
                    "height": int(p.layer_res[i, 1]),
                    "invz_min": float(p.invz_min[i]),
                    "invz_max": float(p.invz_max[i]),
                    "render_order": i,
                }
                for i in range(p.num_layers)
            ],
        }

    def render(self, camera, **kwargs):
        opts = dict(background=self.background, **kwargs)
        if self.render_mode == "mesh":
            opts.setdefault("delta_invz_threshold", self.gradient_threshold)
            opts.setdefault("show_depth", self.show_depth)
            return render(self.projector, camera, mode="mesh", **opts)
        opts.setdefault("feathering", self.feathering)
        return render(self.projector, camera, mode="raycast", **opts)


@dataclass
class Scene:
    """A collection of projectors plus scene-level render settings — the
    analog of the reference's THREE.Scene + duck-typed projector scan
    (HoloRenderer.ts:169-179)."""

    projectors: list[Projector] = field(default_factory=list)
    background: tuple = (0.0, 0.0, 0.0, 0.0)

    def add(self, projector: Projector) -> None:
        self.projectors.append(projector)

    def render(self, camera, mode: str = "raycast", **kwargs):
        kwargs.setdefault("background", self.background)
        return render(self.projectors, camera, mode=mode, **kwargs)
