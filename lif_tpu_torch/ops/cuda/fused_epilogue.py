"""The fused epilogue on Hopper: the wrapper of the CUDA kernel
csrc/fused_epilogue.cu.

What follows the lateral marches of one pose chunk of multi-projector
fusion (models/renderer.py::render_fused_fast_batch), finished into the
caller's frames: for each projector and layer the hit test at the true
source position, the edge taper and mask, the front-to-back over and the
frontmost hit's inverse depth; then the merge across the projectors
(composite.fuse_views: the frontmost surface, the triangular weights of
fuse_tol), the background and sRGB. It replaces no TPU kernel (lif_tpu
leaves the stage to XLA's fusion); in the port it replaces a chain of
PyTorch operators, stacks and concatenations, which is its plain version,
fused_epilogue_plain, and which the wrapper runs for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ...utils import profiling
from .. import composite as _composite
from ..sweep_march import TranslationPlan, _finalize
from .build import load_library
from .sweep_march import _MASK_MODES, _check

__all__ = ["INLINE_ENTRIES", "FusedLayer", "fused_epilogue",
           "fused_epilogue_plain"]

# the kernel's Entry record: the march outputs' and poses' pointers, the
# march's width, the flags (the mask mode, and 4 on a projector's last
# layer) and the hit test's float32 numbers (f1, bx, by, offset x, offset
# y, crop_y, 1 / src_w, 1 / (src_h + 2 crop_y))
_ENTRY = np.dtype([("ptr", "<u8", (4,)), ("w", "<i4"), ("flags", "<i4"),
                   ("geom", "<f4", (8,))])
assert _ENTRY.itemsize == 72
_LAST = 4
# the kernel's kInline: entries that ride in its parameters; the rest are
# uploaded to the device with the launch
INLINE_ENTRIES = 32


class FusedLayer(NamedTuple):
    """One layer of one projector of a fused pose chunk: the lateral
    march's outputs at its (padded) width W = plan.out_w, found and
    invz_star (B, H, W) and rgba_star (B, H, W, 4), float32; poses, the
    projector's (B, 3) float32 positions on the same device; and the hit
    test's numbers as _finalize takes them (the march's plan, the source
    focal f1, the constant source offset and the outpaint crop)."""

    found: torch.Tensor
    invz_star: torch.Tensor
    rgba_star: torch.Tensor
    poses: torch.Tensor
    plan: TranslationPlan
    f1: float
    offset: tuple = (0.0, 0.0)
    crop_y: int = 0


def fused_epilogue_plain(views, out, *, background, feathering: float,
                         fuse_tol: float, to_srgb: bool):
    """The kernel's plain version, on any device: the PyTorch chain it
    replaces, operator for operator. For each projector, given as
    (mask_mode, its FusedLayers front to back: any iterable, consumed
    layer by layer, so a lazy one holds one layer's march at a time),
    _finalize(raw=True) of each layer, the front-to-back over and the
    frontmost hit's inverse depth; composite.fuse_views over the stacked
    projectors; finish_over_background; then the true width into `out`,
    the caller's (B, H, W_true, 4) frames. Returns out."""
    zero_bg = np.zeros(4, np.float32)
    view_rgb, view_a, view_front = [], [], []
    for mask_mode, layers in views:
        acc_rgb = acc_a = front = None
        for lay in layers:
            rgba, alpha, _, izs = _finalize(
                lay.plan, lay.found, lay.invz_star, lay.rgba_star, lay.poses,
                lay.f1, zero_bg, feathering, mask_mode, False, raw=True,
                offset=lay.offset, crop_y=lay.crop_y)
            with profiling.span("lif.composite"):
                if acc_rgb is None:
                    acc_rgb = alpha[..., None] * rgba[..., :3]
                    acc_a = alpha
                    front = torch.where(alpha > 0.0, izs, 0.0)
                else:
                    acc_rgb = acc_rgb + (
                        1.0 - acc_a[..., None]
                    ) * alpha[..., None] * rgba[..., :3]
                    new_hit = (alpha > 0.0) & (front == 0.0)
                    front = torch.where(new_hit, izs, front)
                    acc_a = acc_a + (1.0 - acc_a) * alpha
        view_rgb.append(acc_rgb)
        view_a.append(acc_a)
        view_front.append(front)
    with profiling.span("lif.merge"):
        color, alpha = _composite.fuse_views(
            torch.stack(view_rgb), torch.stack(view_a),
            torch.stack(view_front), fuse_tol)
    with profiling.span("lif.composite"):
        done = _composite.finish_over_background(color, alpha, background,
                                                 to_srgb)
        out.copy_(done[:, :, :out.shape[2]])
    return out


_ARGTYPES = (
    [ctypes.c_void_p] * 2  # the host table, its part past kInline (device)
    + [ctypes.c_int] * 2  # entries, V
    + [ctypes.c_void_p] * 2  # background (or None), out
    + [ctypes.c_int] * 3  # B, H, W_true
    + [ctypes.c_double, ctypes.c_int]  # fuse_tol, fuse_tol <= 0
    + [ctypes.c_double] * 3  # feathering f, 1 - f, 1 - (1 - f)
    + [ctypes.c_float] * 4  # the background, unless on the device
    + [ctypes.c_int]  # to_srgb
    + [ctypes.c_void_p]  # stream
)


def _lib():
    lib = load_library("fused_epilogue")
    fn = lib.lif_fused_epilogue
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_layer(mask_mode, lay, b, h, w_true):
    """Raise ValueError for a projector layer the kernel does not take."""
    if mask_mode not in _MASK_MODES:
        raise ValueError(f"unsupported mask_mode: {mask_mode}")
    w = lay.found.shape[-1]
    _check(lay.found, "found", torch.float32, (b, h, w))
    _check(lay.invz_star, "invz_star", torch.float32, (b, h, w))
    _check(lay.rgba_star, "rgba_star", torch.float32, (b, h, w, 4))
    _check(lay.poses, "poses", torch.float32, (b, 3))
    plan = lay.plan
    if (plan.out_w, plan.out_h) != (w, h) or w < w_true:
        raise ValueError(f"plan {plan} and a true width of {w_true} "
                         f"do not fit the march's {w}x{h} outputs")


def _entry_table(views) -> np.ndarray:
    """The kernel's entry table: one _ENTRY record a projector layer,
    projector by projector and front to back, the last layer of each
    flagged. views: per projector (mask_mode, its FusedLayers)."""
    rec = np.zeros(sum(len(lays) for _, lays in views), _ENTRY)
    k = 0
    for mask_mode, lays in views:
        for l, lay in enumerate(lays):
            plan, crop_y = lay.plan, int(lay.crop_y)
            last = _LAST if l == len(lays) - 1 else 0
            rec[k] = ((lay.found.data_ptr(), lay.invz_star.data_ptr(),
                       lay.rgba_star.data_ptr(), lay.poses.data_ptr()),
                      lay.found.shape[-1], _MASK_MODES[mask_mode] | last,
                      (float(lay.f1), (plan.src_w - plan.out_w) / 2.0,
                       (plan.src_h - plan.out_h) / 2.0, float(lay.offset[0]),
                       float(lay.offset[1]), crop_y,
                       np.float32(1.0) / np.float32(plan.src_w),
                       np.float32(1.0) / np.float32(plan.src_h + 2 * crop_y)))
            k += 1
    return rec


def fused_epilogue(views, out, *, background, feathering: float,
                   fuse_tol: float, to_srgb: bool):
    """Finish one fused pose chunk into `out`, the caller's (B, H, W_true,
    4) frames (a slice of the call's output): the fused epilogue kernel
    for CUDA tensors (one launch, counted in `fused_epilogue.launches`,
    for any number of projectors and layers: past INLINE_ENTRIES layers
    the rest of the entry table is uploaded with the launch),
    fused_epilogue_plain for CPU tensors.

    views: per projector (mask_mode, its FusedLayers front to back: any
    iterable); background: (4,) host values, or a CUDA tensor read on the
    device. Returns out."""
    if out.device.type == "cpu":
        return fused_epilogue_plain(
            views, out, background=background, feathering=feathering,
            fuse_tol=fuse_tol, to_srgb=to_srgb)
    views = [(mode, list(layers)) for mode, layers in views]
    if not views or not all(layers for _, layers in views):
        raise ValueError("the fused epilogue needs at least one projector "
                         "and a layer for each")
    b, h, w_true = out.shape[:3]
    _check(out, "out", torch.float32, (b, h, w_true, 4))
    for mask_mode, layers in views:
        for lay in layers:
            _check_layer(mask_mode, lay, b, h, w_true)
    table = _entry_table(views)
    bg_dev = None
    bg = (0.0, 0.0, 0.0, 0.0)
    if isinstance(background, torch.Tensor) and background.is_cuda:
        # read on the device: no wait on the stream
        bg_dev = background.to(device=out.device,
                               dtype=torch.float32).reshape(4).contiguous()
    else:
        bg = torch.as_tensor(background,
                             dtype=torch.float32).reshape(4).tolist()
    f = max(float(feathering), 1e-6)
    fn = _lib()
    with torch.cuda.device(out.device):
        far = None
        if len(table) > INLINE_ENTRIES:
            # pinned, so the copy rides the stream without a wait; the host
            # allocator keeps the block until the copy has run
            far = torch.from_numpy(
                table[INLINE_ENTRIES:].view(np.uint8)).pin_memory().to(
                    out.device, non_blocking=True)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            table.ctypes.data, None if far is None else far.data_ptr(),
            len(table), len(views),
            None if bg_dev is None else bg_dev.data_ptr(), out.data_ptr(), b,
            h, w_true, float(fuse_tol), int(float(fuse_tol) <= 0.0), f,
            1.0 - f, 1.0 - (1.0 - f), *bg, int(bool(to_srgb)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"lif_fused_epilogue launch failed: CUDA error {err}")
    fused_epilogue.launches += 1
    return out


fused_epilogue.launches = 0
