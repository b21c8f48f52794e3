"""Projector: the scene object holding textures, intrinsics, and pose.

The counterpart of lif_tpu.models.projector, as a frozen dataclass in
place of a flax struct: stacked, padded layer textures plus the pinhole
model and world pose. The textures (rgb/disp/mask) are torch tensors on
the render device, the card unless the caller asks for another
(Projector.to moves them); the small metadata arrays stay host numpy,
because the renderer plans on the host.
`HoloProjectorOptions` semantics are preserved: intrinsics {fx, fy, cx,
cy} in pixels, invDepthRange {min, max, baseline}, width/height.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Projector", "projector_from_arrays", "projector_from_reference"]

MAX_LAYERS = 4  # reference: RaycastPlane.ts:218


@dataclasses.dataclass(frozen=True, eq=False)
class Projector:
    """A light-field projector: LDI layer stack + pinhole model + world pose.

    Texture fields (torch float32 tensors on the render device):
      rgb: (L, Hmax, Wmax, 3) linear-light colours, GL-oriented, padded to
        the largest layer.
      disp: (L, Hmax, Wmax) normalized inverse depth in [0, 1].
      mask: (L, Hmax, Wmax) alpha mask (ones when absent).

    Host fields (numpy float32):
      layer_res: (L, 2) logical (width, height) per layer.
      invz_min/invz_max: (L,) inverse-depth range per layer (LIF units,
        1/m; the kernels divide by `baseline`).
      focal: (L,) focal length in source pixels per layer.
      skew: (2,) source frustum-skew tangents (sk1).
      position: (3,) world position. rotation: (3, 3) world rotation.
      baseline: () baseline in meters.

    num_layers, width, height (of the base view) are ints.
    """

    rgb: torch.Tensor
    disp: torch.Tensor
    mask: torch.Tensor
    layer_res: np.ndarray
    invz_min: np.ndarray
    invz_max: np.ndarray
    focal: np.ndarray
    skew: np.ndarray
    position: np.ndarray
    rotation: np.ndarray
    baseline: np.float32
    num_layers: int
    width: int
    height: int

    @property
    def device(self) -> torch.device:
        return self.disp.device

    @property
    def intrinsics(self) -> dict:
        """Pixel intrinsics of the base view (fx = fy; centered principal
        point unless skewed — reference LifLoader.ts:112-130)."""
        fx = float(self.focal[0])
        cx = self.width / 2.0 - float(self.skew[0]) * fx
        cy = self.height / 2.0 - float(self.skew[1]) * fx
        return {"fx": fx, "fy": fx, "cx": cx, "cy": cy}

    def to(self, device) -> "Projector":
        """A copy whose textures live on `device`; upload once before
        steady-state rendering."""
        return dataclasses.replace(
            self,
            rgb=self.rgb.to(device),
            disp=self.disp.to(device),
            mask=self.mask.to(device),
        )


def projector_from_arrays(
    rgb,
    disp,
    mask=None,
    *,
    focal_px: float,
    invz_min: float,
    invz_max: float,
    baseline: float = 0.063,
    skew=(0.0, 0.0),
    position=(0.0, 0.0, 0.0),
    rotation=None,
    extra_layers: list[dict] | None = None,
    device=None,
) -> Projector:
    """Build a Projector from in-memory arrays (single or multi layer).

    ``rgb`` (H, W, 3) linear GL-oriented, ``disp`` (H, W) in [0,1].
    ``extra_layers``: optional list of dicts with keys rgb/disp/mask/
    focal_px/invz_min/invz_max for LDI layers beyond the first.
    The textures are built on `device`: None means the card ("cuda"),
    and torch raises where there is none; pass device="cpu" for the
    plain-PyTorch twins.
    """
    layers = [
        dict(
            rgb=np.asarray(rgb, np.float32),
            disp=np.asarray(disp, np.float32),
            mask=None if mask is None else np.asarray(mask, np.float32),
            focal_px=focal_px,
            invz_min=invz_min,
            invz_max=invz_max,
        )
    ]
    layers.extend(extra_layers or [])
    return _stack_layers(
        layers,
        skew=skew,
        position=position,
        rotation=rotation,
        baseline=baseline,
        device=_device(device),
    )


def _device(device) -> torch.device:
    """The render device: the card unless the caller names another."""
    return torch.device("cuda" if device is None else device)


def _stack_layers(layers, *, skew, position, rotation, baseline,
                  device) -> Projector:
    n = min(len(layers), MAX_LAYERS)
    layers = layers[:n]
    h_max = max(l["rgb"].shape[0] for l in layers)
    w_max = max(l["rgb"].shape[1] for l in layers)

    rgb = np.zeros((n, h_max, w_max, 3), np.float32)
    disp = np.zeros((n, h_max, w_max), np.float32)
    mask = np.zeros((n, h_max, w_max), np.float32)
    layer_res = np.zeros((n, 2), np.float32)
    invz_min = np.zeros((n,), np.float32)
    invz_max = np.zeros((n,), np.float32)
    focal = np.zeros((n,), np.float32)

    for i, l in enumerate(layers):
        h, w = l["rgb"].shape[:2]
        rgb[i, :h, :w] = l["rgb"]
        disp[i, :h, :w] = l["disp"]
        mask[i, :h, :w] = (
            np.ones((h, w), np.float32) if l.get("mask") is None else l["mask"]
        )
        layer_res[i] = (w, h)
        invz_min[i] = l["invz_min"]
        invz_max[i] = l["invz_max"]
        focal[i] = l["focal_px"]

    base_h, base_w = layers[0]["rgb"].shape[:2]
    return Projector(
        rgb=torch.from_numpy(rgb).to(device),
        disp=torch.from_numpy(disp).to(device),
        mask=torch.from_numpy(mask).to(device),
        layer_res=layer_res,
        invz_min=invz_min,
        invz_max=invz_max,
        focal=focal,
        skew=np.asarray(skew, np.float32),
        position=np.asarray(position, np.float32),
        rotation=np.asarray(
            np.eye(3) if rotation is None else rotation, np.float32
        ),
        baseline=np.float32(baseline),
        num_layers=n,
        width=int(base_w),
        height=int(base_h),
    )


def projector_from_reference(obj, device=None) -> Projector:
    """The port's Projector holding the same scene as `obj` — a
    lif_tpu.Projector, or any object with its fields as arrays. This is
    how a scene built or loaded by the JAX package is carried across, so
    that both packages render identical inputs. `device` as in
    projector_from_arrays (None: the card)."""
    device = _device(device)

    def host(name):
        return np.array(getattr(obj, name), dtype=np.float32)

    def tex(name):
        return torch.from_numpy(host(name)).to(device)

    return Projector(
        rgb=tex("rgb"),
        disp=tex("disp"),
        mask=tex("mask"),
        layer_res=host("layer_res"),
        invz_min=host("invz_min"),
        invz_max=host("invz_max"),
        focal=host("focal"),
        skew=host("skew"),
        position=host("position"),
        rotation=host("rotation"),
        baseline=np.float32(host("baseline")),
        num_layers=int(obj.num_layers),
        width=int(obj.width),
        height=int(obj.height),
    )
