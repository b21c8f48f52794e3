"""The billboard splat on Hopper: the wrapper of the CUDA kernel
csrc/splat_march.cu.

The counterpart of lif_tpu.ops.pallas.splat_march, which holds the TPU
kernel this one replaces. What the kernel computes is the same — each
target pixel walks its pose's integer-parallax ladder near -> far, the
first covered plane wins, the chain of strictly nearer (or lower-id)
upgrades follows, and the winner's point texel is the colour — but not the
TPU's layout: one thread per (pose, row, column) over the row-major
unpadded source, with no skip tables and no transposed window.

The kernel's plain version is ops.splat_march.billboard_march_plain; a
CUDA tensor never reaches it from here.
"""

from __future__ import annotations

import ctypes

import torch

from .build import load_library

__all__ = ["MAX_PLANES", "sweep_billboard"]

MAX_PLANES = 1024  # the kernel's shared-memory ladder (kMaxPlanes)

_ARGTYPES = (
    [ctypes.c_void_p] * 8  # disp, rgbm, ixs, mms, abp, found, tex, rgba
    + [ctypes.c_int] * 5  # B, K, H, W, pad_lo_x
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


def sweep_billboard(disp, rgbm, ixs, mms, abp, pad_lo_x: int, cx0: float,
                    cy0: float, inv_f: float, half_ps: float):
    """Launch the billboard kernel for a lateral pose batch.

    disp: (H, W) float32 disparity; rgbm: (H, W, 4) float32 [r, g, b,
    mask]; ixs: (B, K) int32 window starts and mms: (B, K) float32 shifts
    from billboard_shift_tables; abp: (B, 3) float32 [A, Bc, su_half_max]
    from billboard_pose_scalars; the host floats as
    billboard_march_plain takes them. Returns found (B, H, W), tex
    (B, H, W) and rgba (B, H, W, 4), float32. `sweep_billboard.launches`
    counts the launches."""
    h, w = disp.shape
    b, k = ixs.shape
    _check(disp, "disp", torch.float32, (h, w))
    _check(rgbm, "rgbm", torch.float32, (h, w, 4))
    _check(ixs, "ixs", torch.int32, (b, k))
    _check(mms, "mms", torch.float32, (b, k))
    _check(abp, "abp", torch.float32, (b, 3))
    if not 1 <= k <= MAX_PLANES:
        raise ValueError(f"{k} planes: the kernel takes 1..{MAX_PLANES}")
    dev = disp.device
    found = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    tex = torch.empty_like(found)
    rgba = torch.empty((b, h, w, 4), dtype=torch.float32, device=dev)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            disp.data_ptr(), rgbm.data_ptr(), ixs.data_ptr(), mms.data_ptr(),
            abp.data_ptr(), found.data_ptr(), tex.data_ptr(), rgba.data_ptr(),
            b, k, h, w, int(pad_lo_x), float(cx0), float(cy0), float(inv_f),
            float(half_ps), stream,
        )
    if err != 0:
        raise RuntimeError(f"lif_billboard_march launch failed: CUDA error "
                           f"{err}")
    sweep_billboard.launches += 1
    return found, tex, rgba


sweep_billboard.launches = 0
