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

from ..core import pose as _pose
from ..io import decode as _decode

__all__ = [
    "Projector",
    "projector_from_arrays",
    "projector_from_lif_view",
    "projector_from_reference",
    "resample_projector",
]

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

    @property
    def inv_depth_range(self) -> dict:
        """The base layer's inverse-depth range (LIF units) and baseline,
        the reference's invDepthRange {min, max, baseline}."""
        return {
            "min": float(self.invz_min[0]),
            "max": float(self.invz_max[0]),
            "baseline": float(self.baseline),
        }

    def frustum_corners(self) -> np.ndarray:
        """8 frustum corners in projector-local space (core.camera's
        frustum_corners of the base view). reference:
        HoloProjector.ts:388-433."""
        from ..core.camera import frustum_corners

        return frustum_corners(
            self.intrinsics, self.width, self.height,
            float(self.invz_min[0]), float(self.invz_max[0]),
            float(self.baseline),
        )

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


def projector_from_lif_view(view: dict, baseline_meters: float = 0.063,
                            device=None) -> Projector:
    """Build a Projector from a normalized LIF view dict (io.schema), its
    textures on `device` (None: the card).

    Faithful to createHoloProjectorFromLifView (reference:
    src/LifLoader.ts:100-208), as lif_tpu's:
      * frustum_skew (array or {x,y} form) carried as sk1; the derived
        principal point is cx = W/2 - skew.x*focal (exposed via
        Projector.intrinsics);
      * LIF positions are baseline-normalized -> scaled to meters;
      * rotation converted via the LIF slant/roll encoding;
      * LDI layers from layers_top_to_bottom with the per-layer
        intrinsics fallback chain (HoloProjector.ts:294-376).
    """
    skew_raw = view.get("frustum_skew")
    if skew_raw is None:
        skew = (0.0, 0.0)
    elif isinstance(skew_raw, dict):
        skew = (float(skew_raw.get("x", 0.0)), float(skew_raw.get("y", 0.0)))
    else:
        skew = (float(skew_raw[0]), float(skew_raw[1]))

    position = np.asarray(
        [float(v) for v in (view.get("position") or (0.0, 0.0, 0.0))]
    ) * baseline_meters  # LIF positions are baseline-normalized (:169-189)
    rotation = (
        _pose.lif_rotation_to_matrix(view["rotation"])
        if view.get("rotation") is not None
        else np.eye(3)
    )

    def layer_from(obj, fallback):
        w = int(obj.get("width_px") or fallback["width_px"])
        focal = float(obj.get("focal_px") or fallback["focal_px"])
        cam = obj.get("camera_data")
        if cam:  # per-layer intrinsics fallback (HoloProjector.ts:332-348)
            focal = cam["focal_ratio_to_width"] * w
        invz = obj.get("inv_z_map") or fallback["inv_z_map"]
        rgb = _decode.decode_rgb(obj["image"]["bytes"])
        disp_src = (obj.get("inv_z_map", {}).get("bytes")
                    or fallback["inv_z_map"]["bytes"])
        disp = _decode.decode_depth(disp_src)
        mask_bytes = (obj.get("mask") or {}).get("bytes")
        mask = (
            None
            if mask_bytes is None
            else _decode.decode_mask(mask_bytes, disp.shape)
        )
        return dict(
            rgb=rgb,
            disp=disp,
            mask=mask,
            focal_px=focal,
            invz_min=float(invz["min"]),
            invz_max=float(invz["max"]),
        )

    ldi = view.get("layers_top_to_bottom")
    if ldi:
        layers = [layer_from(layer, view) for layer in ldi]
    else:
        layers = [layer_from(view, view)]

    return _stack_layers(
        layers,
        skew=skew,
        position=position,
        rotation=rotation,
        baseline=baseline_meters,
        device=_device(device),
    )


def _resize_bilinear(tex: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """(H, W[, C]) -> (nh, nw[, C]) bilinear with half-pixel centers,
    antialiased (a widened triangle filter) when it shrinks: the filter of
    lif_tpu's jax.image.resize(..., "bilinear")."""
    x = tex.to(torch.float32)
    nchw = x.permute(2, 0, 1)[None] if x.ndim == 3 else x[None, None]
    y = torch.nn.functional.interpolate(
        nchw, size=(nh, nw), mode="bilinear", align_corners=False,
        antialias=True,
    )[0]
    return y.permute(1, 2, 0) if x.ndim == 3 else y[0]


def resample_projector(
    projector: Projector,
    scale: float,
    out_w: int | None = None,
    out_h: int | None = None,
    device=None,
) -> Projector:
    """Bilinearly resample every layer by `scale` (focal scales with it),
    optionally center-cropping to (out_w, out_h); the new textures on
    `device` (None: the card).

    The offline analog of the reference's viewport scaling
    (textureUtils.ts:126-136 calculateViewportScale): rendering at an
    output resolution other than the source's. A center crop keeps the
    principal point centered, so the resampled projector stays valid for
    the centered-pp fast paths; inverse-depth ranges and pose are
    resolution-independent and unchanged. The resize runs on the
    projector's device.
    """
    layers = []
    for i in range(projector.num_layers):
        w_i = int(projector.layer_res[i, 0])
        h_i = int(projector.layer_res[i, 1])
        nw, nh = round(w_i * scale), round(h_i * scale)
        cw = min(out_w or nw, nw)
        ch = min(out_h or nh, nh)
        x0, y0 = (nw - cw) // 2, (nh - ch) // 2

        def resized(tex):
            out = _resize_bilinear(tex[i, :h_i, :w_i], nh, nw)
            return out[y0 : y0 + ch, x0 : x0 + cw].cpu().numpy()

        layers.append(dict(
            rgb=resized(projector.rgb),
            disp=resized(projector.disp),
            mask=resized(projector.mask),
            focal_px=float(projector.focal[i]) * scale,
            invz_min=float(projector.invz_min[i]),
            invz_max=float(projector.invz_max[i]),
        ))
    return _stack_layers(
        layers,
        skew=np.asarray(projector.skew),
        position=np.asarray(projector.position),
        rotation=np.asarray(projector.rotation),
        baseline=float(projector.baseline),
        device=_device(device),
    )
