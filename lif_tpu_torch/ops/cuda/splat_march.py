"""The billboard splat on Hopper: the wrapper of the CUDA kernel
csrc/splat_march.cu.

The counterpart of lif_tpu.ops.pallas.splat_march, which holds the TPU
kernel this one replaces. The function is the same — for every target
pixel the nearest covering point texel of its row (the lower source
column among equal texels), its disparity texel and its colour — but not
the algorithm: lif_tpu walks each target pixel's integer-parallax ladder
(the gather dual), the kernel scatters each source pixel into a row
z-buffer in shared memory with an atomic min, one block per row and a
few poses. The two agree while su_half < 1, which sweep_billboard checks.

The kernel's plain version is ops.splat_march.billboard_scatter_plain (and
the dual's, billboard_march_plain, computes the same); a CUDA tensor never
reaches either from here.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library

__all__ = ["MAX_PLANES", "MAX_WIDTH", "check_su_half", "sweep_billboard"]

MAX_PLANES = 1024  # the ladders billboard_shift_tables builds stay under it
# the widest row whose u64 z-buffer fits one block's shared memory (227 KB)
MAX_WIDTH = 232448 // 8

_ARGTYPES = (
    [ctypes.c_void_p] * 7  # disp, rgbm, mms, abp, found, tex, rgba
    + [ctypes.c_int] * 4  # B, K, H, W
    + [ctypes.c_float] * 4  # cx0, cy0, inv_f, half_ps
    + [ctypes.c_void_p]  # stream
)


def _lib():
    lib = load_library("splat_march")
    fn = lib.lif_billboard_march
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check(t, name, dtype, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_su_half(abp):
    """Raise ValueError unless every pose's su_half_max (abp[:, 2]) is
    under 1: beyond it a footprint can reach two rungs of one row, and
    neither the scatter nor the dual is the z-buffered splat any more."""
    su = torch.as_tensor(abp)[:, 2]
    if not bool((su < 1.0).all()):
        raise ValueError(
            f"the billboard splat needs su/2 < 1, got su/2 up to "
            f"{float(su.max()):.4f}: use a smaller point size"
        )


def sweep_billboard(disp, rgbm, ixs, mms, abp, pad_lo_x: int, cx0: float,
                    cy0: float, inv_f: float, half_ps: float):
    """Launch the billboard kernel for a lateral pose batch.

    disp: (H, W) float32 disparity; rgbm: (H, W, 4) float32 [r, g, b,
    mask]; ixs: (B, K) int32 window starts and mms: (B, K) float32 shifts
    from billboard_shift_tables; abp: (B, 3) float32 [A, Bc, su_half_max]
    from billboard_pose_scalars; the host floats as
    billboard_march_plain takes them (the arguments of both plain
    versions; the scatter reads the ladder's shifts only, since ixs =
    pad_lo_x - mms). Raises ValueError where su_half_max reaches 1, for W
    over MAX_WIDTH and for K over MAX_PLANES. Returns
    found (B, H, W), tex (B, H, W) and rgba (B, H, W, 4), float32.
    `sweep_billboard.launches` counts the launches."""
    check_su_half(abp)
    h, w = disp.shape
    b, k = ixs.shape
    _check(disp, "disp", torch.float32, (h, w))
    _check(rgbm, "rgbm", torch.float32, (h, w, 4))
    _check(ixs, "ixs", torch.int32, (b, k))
    _check(mms, "mms", torch.float32, (b, k))
    _check(abp, "abp", torch.float32, (b, 3))
    if not 1 <= k <= MAX_PLANES:
        raise ValueError(f"{k} planes: the kernel takes 1..{MAX_PLANES}")
    if w > MAX_WIDTH:
        raise ValueError(f"width {w}: the row z-buffer holds at most "
                         f"{MAX_WIDTH} columns")
    dev = disp.device
    found = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    tex = torch.empty_like(found)
    rgba = torch.empty((b, h, w, 4), dtype=torch.float32, device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            disp.data_ptr(), rgbm.data_ptr(), mms.data_ptr(), abp.data_ptr(),
            found.data_ptr(), tex.data_ptr(), rgba.data_ptr(), b, k, h, w,
            float(cx0), float(cy0), float(inv_f), float(half_ps), stream,
        )
    if err != 0:
        raise RuntimeError(f"lif_billboard_march launch failed: CUDA error "
                           f"{err}")
    sweep_billboard.launches += 1
    return found, tex, rgba


sweep_billboard.launches = 0
