"""LIF metadata normalization: legacy keys, legacy camera data, LDI outpainting.

The counterpart of lif_tpu.io.schema (copied: the port imports nothing of
lif_tpu). Faithful re-implementation of the reference loader's JSON post-processing
(reference: src/LifLoader.ts:308-319 key renames, :443-540 view processing),
operating on plain dicts; blob references are resolved to raw bytes via the
parsed container instead of browser blob URLs.
"""

from __future__ import annotations

from typing import Any

from . import container as _container
from .decode import image_dimensions

# Legacy -> standard key renames. reference: LifLoader.ts:310-319. Note the
# deliberate inversion: inv_z_dist_min -> "max" and inv_z_dist_max -> "min"
# (inverse-depth vs disparity orientation).
_OLD_KEYS = [
    "albedo",
    "disparity",
    "inv_z_dist",
    "max_disparity",
    "min_disparity",
    "inv_z_dist_min",
    "inv_z_dist_max",
]
_NEW_KEYS = ["image", "inv_z_map", "inv_z_map", "max", "min", "max", "min"]


def replace_keys(obj: Any) -> Any:
    """Recursively rename legacy keys. reference: LifLoader.ts:408-423."""
    if isinstance(obj, dict):
        out = {}
        for key, value in obj.items():
            new_key = _NEW_KEYS[_OLD_KEYS.index(key)] if key in _OLD_KEYS else key
            out[new_key] = replace_keys(value)
        return out
    if isinstance(obj, list):
        return [replace_keys(v) for v in obj]
    return obj


def _attach_blob(obj: dict, cont: _container.Container) -> None:
    """Resolve image/inv_z_map/mask blob_ids to raw bytes (the python
    equivalent of the reference's blob-URL materialization,
    LifLoader.ts:450-479)."""
    image = obj.get("image")
    if image is not None and "blob_id" in image:
        image["bytes"] = cont.blob(image["blob_id"])
    invz = obj.get("inv_z_map")
    if invz is not None and "blob_id" in invz:
        invz["bytes"] = cont.blob(invz["blob_id"])
    mask = obj.get("mask")
    if mask is not None and "blob_id" in mask:
        mask["bytes"] = cont.blob(mask["blob_id"])


def process_views(meta: dict, cont: _container.Container) -> list[dict]:
    """Normalize views in place and return them.

    Handles (all per reference: LifLoader.ts:481-537):
      * blob resolution for views and layers;
      * pre-5.3 legacy camera_data back-fill: dims from the image,
        focal_px = focal_ratio_to_width * width, position/rotation/skew
        lifted from camera_data, invZ range rescaled by
        -focal_ratio_to_width;
      * legacy layered_depth_image_data with outpainting: layer dims =
        view dims + outpainting, invZ divided by (1 + outpaint_w/width),
        then the same focal_ratio rescale per layer.
    """
    views = meta.get("views") or []
    for view in views:
        _attach_blob(view, cont)

        if not view.get("width_px"):
            # Legacy (pre-5.3): derive from image + camera_data.
            width, height = image_dimensions(view["image"]["bytes"])
            view["width_px"] = width
            view["height_px"] = height
            cam = view["camera_data"]
            view["focal_px"] = cam["focal_ratio_to_width"] * width
            view["position"] = cam["position"]
            view["frustum_skew"] = cam.get("frustum_skew")
            view["rotation"] = cam["rotation"]
            view["inv_z_map"]["max"] /= -cam["focal_ratio_to_width"]
            view["inv_z_map"]["min"] /= -cam["focal_ratio_to_width"]

        outpaint_w = outpaint_h = None
        camera_data = None
        if not view.get("layers_top_to_bottom") and view.get("layered_depth_image_data"):
            ldi = view["layered_depth_image_data"]
            view["layers_top_to_bottom"] = ldi["layers_top_to_bottom"]
            outpaint_w = ldi["outpainting_added_width_px"]
            outpaint_h = ldi["outpainting_added_height_px"]
            camera_data = view.get("camera_data")
            view.pop("camera_data", None)

        for layer in view.get("layers_top_to_bottom") or []:
            _attach_blob(layer, cont)
            if camera_data is not None:
                layer["camera_data"] = camera_data
                layer["outpainting_added_width_px"] = outpaint_w
                layer["outpainting_added_height_px"] = outpaint_h
                layer["inv_z_map"]["min"] /= 1 + outpaint_w / view["width_px"]
                layer["inv_z_map"]["max"] /= 1 + outpaint_w / view["width_px"]
            if layer.get("outpainting_added_width_px"):
                outpaint_w = layer["outpainting_added_width_px"]
                outpaint_h = layer["outpainting_added_height_px"]
                layer["width_px"] = view["width_px"] + outpaint_w
                layer["height_px"] = view["height_px"] + outpaint_h
                layer["focal_px"] = view["focal_px"]
                ratio = layer["camera_data"]["focal_ratio_to_width"]
                layer["inv_z_map"]["max"] /= -ratio
                layer["inv_z_map"]["min"] /= -ratio
                layer.pop("camera_data", None)
                layer.pop("outpainting_added_width_px", None)
                layer.pop("outpainting_added_height_px", None)
                view.pop("layered_depth_image_data", None)
                view.pop("camera_data", None)
    return views


def load_meta(cont: _container.Container) -> dict:
    """Parse + normalize the container's scene JSON; views get blob bytes
    attached. Returns {views, stereo_render_data?, baseline_mm?, ...}."""
    meta = replace_keys(cont.json_meta())
    meta["views"] = process_views(meta, cont)
    return meta
