"""WebGL-faithful texture sampling as plain tensor indexing.

The counterpart of lif_tpu.ops.sampling. Semantics reproduced:
  * LinearFilter + ClampToEdgeWrapping bilinear: sample position
    ``st = uv * res - 0.5``, texel indices clamped to [0, res-1].
  * readDisp's 2-texel interior clamp before sampling
    (reference: src/shaders/rayCastMonoLDI.glsl:59-61).

Textures are stored GL-oriented (row 0 = v=0 = image bottom). The logical
resolution ``res=(w, h)`` may be smaller than the stored array (padded
layers); indices clamp to the logical extent, so the pad is never read.
The JAX package fetches a precomputed 2x2 patch table in one row gather
(a TPU gather workaround); here the four taps are read directly.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "bilinear_sample",
    "bilinear_sample_packed",
    "nearest_sample",
    "pack_rgbm",
    "read_disp",
]


def bilinear_sample(tex: torch.Tensor, u, v, res_w, res_h) -> torch.Tensor:
    """Bilinear sample with clamp-to-edge.

    Args:
      tex: (H, W) or (H, W, C) tensor, GL-oriented.
      u, v: sample coordinates in [0, 1], tensors of one shape.
      res_w, res_h: logical texture resolution (<= stored dims), Python
        numbers.

    Returns a tensor of shape ``u.shape`` (+ channel dim if tex has one).
    """
    sx = u * res_w - 0.5
    sy = v * res_h - 0.5
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0 = x0.to(torch.int64)
    y0 = y0.to(torch.int64)
    wmax = int(res_w) - 1
    hmax = int(res_h) - 1
    ix0 = torch.clamp(x0, 0, wmax)
    ix1 = torch.clamp(x0 + 1, 0, wmax)
    iy0 = torch.clamp(y0, 0, hmax)
    iy1 = torch.clamp(y0 + 1, 0, hmax)
    if tex.ndim == 3:
        fx = fx[..., None]
        fy = fy[..., None]
    t00 = tex[iy0, ix0]
    t01 = tex[iy0, ix1]
    t10 = tex[iy1, ix0]
    t11 = tex[iy1, ix1]
    top = t00 + (t01 - t00) * fx
    bot = t10 + (t11 - t10) * fx
    return top + (bot - top) * fy


def nearest_sample(tex: torch.Tensor, u, v, res_w, res_h) -> torch.Tensor:
    """Nearest-neighbour sample with clamp-to-edge (GL NEAREST); arguments
    as bilinear_sample's."""
    ix = torch.clamp(torch.floor(u * res_w).to(torch.int64), 0,
                     int(res_w) - 1)
    iy = torch.clamp(torch.floor(v * res_h).to(torch.int64), 0,
                     int(res_h) - 1)
    return tex[iy, ix]


def _edge_weights(x0, y0, fx, fy, wmax: int, hmax: int):
    """Zero the lerp weight wherever clamping collapses both taps onto one
    texel (left of texel 0's center, or at the logical right/top edge)."""
    fx = torch.where((x0 >= 0) & (x0 < wmax), fx, 0.0)
    fy = torch.where((y0 >= 0) & (y0 < hmax), fy, 0.0)
    return fx, fy


def pack_rgbm(rgb: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Pack (H, W, 3) rgb in [0,1] + (H, W) mask into one int32 channel:
    10 bits per color (rounded half to even) + 1 mask bit. The largest
    value, 1023 << 21 | ..., fits in int32."""
    q = torch.clamp(torch.round(rgb.to(torch.float32) * 1023.0), 0, 1023)
    q = q.to(torch.int32)
    m = (mask > 0.5).to(torch.int32)
    return (q[..., 0] << 21) | (q[..., 1] << 11) | (q[..., 2] << 1) | m


def _unpack_rgbm(packed: torch.Tensor) -> torch.Tensor:
    scale = torch.full((), 1023.0, dtype=torch.float32, device=packed.device)
    r = ((packed >> 21) & 1023).to(torch.float32) / scale
    g = ((packed >> 11) & 1023).to(torch.float32) / scale
    b = ((packed >> 1) & 1023).to(torch.float32) / scale
    m = (packed & 1).to(torch.float32)
    return torch.stack([r, g, b, m], dim=-1)


def bilinear_sample_packed(packed_tex, u, v, res_w, res_h) -> torch.Tensor:
    """Bilinear sample of a pack_rgbm texture with clamp-to-edge: four
    corner reads, unpack, blend. Returns (..., 4) = [r, g, b, mask]."""
    sx = u * res_w - 0.5
    sy = v * res_h - 0.5
    fl_x = torch.floor(sx)
    fl_y = torch.floor(sy)
    x0 = fl_x.to(torch.int64)
    y0 = fl_y.to(torch.int64)
    wmax = int(res_w) - 1
    hmax = int(res_h) - 1
    fx, fy = _edge_weights(x0, y0, sx - fl_x, sy - fl_y, wmax, hmax)
    fx = fx[..., None]
    fy = fy[..., None]
    ix0 = torch.clamp(x0, 0, wmax)
    iy0 = torch.clamp(y0, 0, hmax)
    ix1 = torch.clamp(x0 + 1, 0, wmax)
    iy1 = torch.clamp(y0 + 1, 0, hmax)
    t00 = _unpack_rgbm(packed_tex[iy0, ix0])
    t01 = _unpack_rgbm(packed_tex[iy0, ix1])
    t10 = _unpack_rgbm(packed_tex[iy1, ix0])
    t11 = _unpack_rgbm(packed_tex[iy1, ix1])
    top = t00 + (t01 - t00) * fx
    bot = t10 + (t11 - t10) * fx
    return top + (bot - top) * fy


def read_disp(disp_tex, u, v, v_min, v_max, res_w, res_h) -> torch.Tensor:
    """Decode inverse depth from a disparity texture.

    Clamps uv to a 2-texel interior border, bilinearly samples, then maps
    [0,1] -> [v_max, v_min]: ``texel * (vMin - vMax) + vMax``.
    reference: rayCastMonoLDI.glsl:59-61.
    """
    # the clamp bounds in float32 arithmetic, as the shader computes them
    bu = float(np.float32(2.0) / np.float32(res_w))
    bv = float(np.float32(2.0) / np.float32(res_h))
    uc = torch.clamp(u, bu, float(np.float32(1.0) - np.float32(bu)))
    vc = torch.clamp(v, bv, float(np.float32(1.0) - np.float32(bv)))
    texel = bilinear_sample(disp_tex, uc, vc, res_w, res_h)
    return texel * float(np.float32(v_min) - np.float32(v_max)) + v_max
