"""The scaled first-crossing march on Hopper: the wrapper of the CUDA
kernel csrc/sweep_scaled.cu.

The counterpart of lif_tpu.ops.pallas.sweep_scaled, which holds the TPU
kernel this one replaces. What the kernel computes is the same — planes
walked near -> far through a separable-affine per-plane warp, the first
crossing with its secant bracket, the optional in-bracket refine
sub-sweep, and in full-color mode the bracket color lerp — but not the
TPU's layout: one thread marches one (pose, row, column) pixel over the
row-major unpadded source, and the transposed stack, hat-candidate
classes, DMA windows and skip tables are gone.

The kernel's plain version is ops.sweep_scaled.march_scaled_plain; a CUDA
tensor never reaches it from here.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..sweep_scaled import ScaledPlan
from .build import load_library

__all__ = ["MAX_PLANES", "march_scaled_cuda", "sweep_scaled"]

MAX_PLANES = 1024  # the kernel's shared-memory tables (kMaxPlanes)

_ARGTYPES = (
    [ctypes.c_void_p] * 7  # disp, rgbm, tabs, dlim, found, invz, rgba
    # B, K, src_h, src_w, out_h, out_w, pad_x, span_x, pad_y, my_lo, my_hi,
    # refine
    + [ctypes.c_int] * 12
    + [ctypes.c_float] * 2  # izmin, izmax
    + [ctypes.c_void_p]  # stream
)


def _lib():
    lib = load_library("sweep_scaled")
    fn = lib.lif_scaled_march
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(t, name, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sweep_scaled(disp, tabs, dlim, plan: ScaledPlan, invz_min, invz_max,
                 refine: int = 0, rgbm=None):
    """Launch the scaled march kernel for a pose batch.

    disp: (Hs, Ws) float32 disparity; tabs: (B, 5, K) scaled_table_stack
    rows [tx, ex, ty, ey, invz]; dlim: (2,) the smallest and largest
    disparity texel; rgbm: optional (4, Hs, Ws) [r, g, b, mask] planes for
    the full-color mode. Returns found (B, out_h, out_w), invz*
    (B, out_h, out_w) and rgba* (B, out_h, out_w, 4) or None, float32.
    `sweep_scaled.launches` counts the launches."""
    src_h, src_w = disp.shape
    b, _, k = tabs.shape
    _check(disp, "disp", (src_h, src_w))
    _check(tabs, "tabs", (b, 5, k))
    _check(dlim, "dlim", (2,))
    if rgbm is not None:
        _check(rgbm, "rgbm", (4, src_h, src_w))
    if not 1 <= k <= MAX_PLANES:
        raise ValueError(f"{k} planes: the kernel takes 1..{MAX_PLANES}")
    if (plan.src_w, plan.src_h) != (src_w, src_h) or refine < 0:
        raise ValueError(f"plan {plan} for a {src_w}x{src_h} source, "
                         f"refine {refine}")
    dev = disp.device
    oh, ow = plan.out_h, plan.out_w
    found = torch.empty((b, oh, ow), dtype=torch.float32, device=dev)
    invz = torch.empty_like(found)
    rgba = (
        torch.empty((b, oh, ow, 4), dtype=torch.float32, device=dev)
        if rgbm is not None else None
    )
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            disp.data_ptr(), None if rgbm is None else rgbm.data_ptr(),
            tabs.data_ptr(), dlim.data_ptr(), found.data_ptr(),
            invz.data_ptr(), None if rgba is None else rgba.data_ptr(),
            b, k, src_h, src_w, oh, ow, plan.pad_lo_x, plan.tab_span_x,
            plan.pad_lo_y, plan.my_lo, plan.my_hi, int(refine),
            float(np.float32(invz_min)), float(np.float32(invz_max)), stream,
        )
    if err != 0:
        raise RuntimeError(f"lif_scaled_march launch failed: CUDA error {err}")
    sweep_scaled.launches += 1
    return found, invz, rgba


sweep_scaled.launches = 0


def march_scaled_cuda(disp, invz_min, invz_max, tabs, plan: ScaledPlan,
                      refine: int = 0, rgbm=None):
    """The scaled march of a pose batch through the kernel: the disparity
    bounds, one launch. Returns found (B, H, W), invz* (B, H, W) and, with
    rgbm, rgba* (B, H, W, 4) — per pose what
    ops.sweep_scaled.march_scaled_plain computes."""
    dev = disp.device
    d = disp.to(dtype=torch.float32).contiguous()
    found, invz, rgba = sweep_scaled(
        d, tabs.to(device=dev, dtype=torch.float32).contiguous(),
        torch.stack(torch.aminmax(d)), plan, invz_min, invz_max,
        refine=refine, rgbm=rgbm,
    )
    return (found, invz) if rgba is None else (found, invz, rgba)
