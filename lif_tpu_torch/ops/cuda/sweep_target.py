"""The target-ray first-crossing march on Hopper: the wrapper of the CUDA
kernel csrc/sweep_target.cu.

The counterpart of lif_tpu.ops.pallas.sweep_target, which holds the TPU
kernel this one replaces. What the kernel computes is the same — planes
walked near -> far along every target ray (source position affine in
invz with per-pixel homography fields), the first crossing with its
secant bracket, the optional in-bracket refine sub-sweep, and in
full-color mode the bracket color lerp — but not the TPU's layout: one
thread marches one (pose, row, column) pixel over the row-major source,
and the window tables and hat-candidate classes are gone. lif_tpu's
skip idea stays, redrawn for warps: the max tables of
ops.sweep_target.skip_tables (built once per texture by the renderer,
and required by the wrapper) let a warp skip runs of planes and a lane
skip single planes, exactly.

The kernel's plain version is ops.sweep_target.march_target_plain (and
the mirror of its skip walk ops.sweep_target.march_target_skip_plain); a
CUDA tensor never reaches either from here.
"""

from __future__ import annotations

import ctypes

import torch

from ..sweep_target import TargetPlan, plane_thresholds, skip_tables
from .build import load_library

__all__ = ["MAX_PLANES", "march_target_cuda", "skip_table_buffer",
           "sweep_target"]

MAX_PLANES = 1024  # the kernel's shared-memory ladder (kMaxPlanes)

_ARGTYPES = (
    [ctypes.c_void_p] * 10  # disp, rgbm, pose, vg, tk, dmax, tables, found,
    # invz, rgba
    + [ctypes.c_int] * 7  # B, K, src_h, src_w, out_h, out_w, refine
    + [ctypes.c_void_p]  # stream
)


def skip_table_buffer(disp):
    """skip_tables(disp) flattened into one float32 buffer (b0, b8, b32),
    the layout the kernel reads."""
    return torch.cat([t.reshape(-1) for t in skip_tables(disp)])


def _lib():
    lib = load_library("sweep_target")
    fn = lib.lif_target_march
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(t, name, shape):
    if t is None:
        raise ValueError(f"{name} is required")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def sweep_target(disp, pose_b, vg, tk, dmax, out_w: int, out_h: int,
                 refine: int = 0, rgbm=None, *, tables):
    """Launch the target-ray march kernel for a pose batch.

    disp: (Hs, Ws) float32 disparity; pose_b: (B, 16) target_pose_scalars
    rows; vg/tk: (B, K) plane invz (descending) and their texel
    thresholds; dmax: (1,) the largest disparity texel; rgbm: optional
    (4, Hs, Ws) [r, g, b, mask] planes for the full-color mode; tables:
    skip_table_buffer(disp). Returns
    found (B, out_h, out_w), invz* (B, out_h, out_w) and rgba*
    (B, out_h, out_w, 4) or None, float32. `sweep_target.launches` counts
    the launches."""
    src_h, src_w = disp.shape
    b, k = vg.shape
    _check(disp, "disp", (src_h, src_w))
    _check(pose_b, "pose_b", (b, 16))
    _check(vg, "vg", (b, k))
    _check(tk, "tk", (b, k))
    _check(dmax, "dmax", (1,))
    if rgbm is not None:
        _check(rgbm, "rgbm", (4, src_h, src_w))
    if not 1 <= k <= MAX_PLANES:
        raise ValueError(f"{k} planes: the kernel takes 1..{MAX_PLANES}")
    if min(src_w, src_h) < 2 or refine < 0:
        raise ValueError(f"source {src_w}x{src_h}, refine {refine}")
    th8, tw8 = -(-(src_h - 1) // 8), -(-(src_w - 1) // 8)
    _check(tables, "tables", ((src_h - 1) * (src_w - 1) + th8 * tw8
                              + -(-th8 // 4) * -(-tw8 // 4),))
    dev = disp.device
    found = torch.empty((b, out_h, out_w), dtype=torch.float32, device=dev)
    invz = torch.empty_like(found)
    rgba = (
        torch.empty((b, out_h, out_w, 4), dtype=torch.float32, device=dev)
        if rgbm is not None else None
    )
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            disp.data_ptr(), None if rgbm is None else rgbm.data_ptr(),
            pose_b.data_ptr(), vg.data_ptr(), tk.data_ptr(), dmax.data_ptr(),
            tables.data_ptr(), found.data_ptr(), invz.data_ptr(),
            None if rgba is None else rgba.data_ptr(),
            b, k, src_h, src_w, out_h, out_w, int(refine), stream,
        )
    if err != 0:
        raise RuntimeError(f"lif_target_march launch failed: CUDA error {err}")
    sweep_target.launches += 1
    return found, invz, rgba


sweep_target.launches = 0


def march_target_cuda(disp, invz_min, invz_max, pose_b, plane_invz,
                      plan: TargetPlan, refine: int = 0, rgbm=None, *,
                      tables):
    """The target-ray march of a pose batch through the kernel: thresholds,
    the disparity bound, one launch. Returns found (B, H, W), invz*
    (B, H, W) and, with rgbm, rgba* (B, H, W, 4) — per pose what
    ops.sweep_target.march_target_plain computes. tables:
    skip_table_buffer(disp), cached with the textures by the renderer."""
    dev = disp.device
    d = disp.to(dtype=torch.float32).contiguous()
    vg = plane_invz.to(device=dev, dtype=torch.float32).contiguous()
    tk = plane_thresholds(vg, invz_min, invz_max).contiguous()
    found, invz, rgba = sweep_target(
        d, pose_b.to(device=dev, dtype=torch.float32).contiguous(), vg, tk,
        d.amax().reshape(1), plan.out_w, plan.out_h, refine=refine,
        rgbm=rgbm, tables=tables,
    )
    return (found, invz) if rgba is None else (found, invz, rgba)
