"""The target and scaled epilogue on Hopper: the wrapper of the CUDA kernel
csrc/posed_epilogue.cu.

What follows the depth-only march of one layer of a pose chunk on the
orbit ('target') and zoom ('scaled') tiers, finished into the caller's
frames: the tier's solved source position, one packed bilinear fetch
there, the edge taper and mask, the premultiply, the LDI over onto the
layers in front, the background and sRGB after the last layer. It
replaces no TPU kernel (lif_tpu leaves the stage to XLA's fusion); in the
port it replaces a chain of PyTorch operators and concatenations, which
is its plain version, posed_epilogue_plain, and which the wrapper runs for
CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import composite as _composite
from .. import sweep_scaled as _sweep_scaled
from .. import sweep_target as _sweep_target
from .build import load_library
from .sweep_march import _MASK_MODES, _check

__all__ = ["posed_epilogue", "posed_epilogue_plain"]

_TIERS = {"target": 0, "scaled": 1}

_ARGTYPES = (
    [ctypes.c_int]  # tier
    # found, invz, poses, packed texture, background (or None), out
    + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 6  # B, H, W (the march's), W_true, texture w, h
    + [ctypes.POINTER(ctypes.c_double)]  # the uv solve's numbers (15)
    + [ctypes.c_double] * 3  # feathering f, 1 - f, 1 - (1 - f)
    + [ctypes.c_float] * 4  # the background, unless on the device
    + [ctypes.c_int] * 4  # mask mode, to_srgb, first, last
    + [ctypes.c_void_p]  # stream
)


def _lib():
    lib = load_library("posed_epilogue")
    fn = lib.lif_posed_epilogue
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _geometry(tier, solve, found_w, found_h, tex_w, tex_h):
    """The kernel's 15 numbers of the tier's uv solve (see
    lif_posed_epilogue), from `solve` as posed_epilogue takes it."""
    plan = solve[0]
    if ((plan.out_w, plan.out_h, plan.src_w, plan.src_h)
            != (found_w, found_h, tex_w, tex_h)):
        raise ValueError(f"plan {plan} does not fit the march's "
                         f"{found_w}x{found_h} outputs and a {tex_w}x{tex_h} "
                         f"texture")
    g = np.zeros(15, np.float64)
    if tier == "target":
        _, izmin, izmax = solve
        g[:6] = (tex_w, tex_h, plan.out_w, plan.out_h,
                 float(np.float32(izmin)), float(np.float32(izmax)))
        return g
    _, f1, fr, dx_user, dy_user, crop_y = solve
    g[:2] = (plan.src_w, plan.src_h + 2 * int(crop_y))
    f32 = _sweep_scaled._f32
    g[6:] = (f32(f1), f32(fr), (plan.src_w - plan.out_w) / 2.0,
             (plan.src_h - plan.out_h) / 2.0, f32(dx_user), f32(dy_user),
             (plan.out_w - 1) / 2.0, (plan.out_h - 1) / 2.0, int(crop_y))
    return g


def posed_epilogue_plain(tier: str, found, invz_star, poses, solve, packed,
                         background, out, *, feathering: float,
                         mask_mode: str, to_srgb: bool, first: bool = True,
                         last: bool = True):
    """The epilogue kernel's plain version, on any device: the PyTorch
    chain it replaces, operator for operator. The tier's fetch and finish
    over a zero background (ops/sweep_target.py::fetch_finish,
    ops/sweep_scaled.py::fetch_finish, as _layer_tier_batch renders each
    layer), then composite.over_into: the over onto the layers in front
    held in `out` (unless `first`), finish_over_background (if `last`)
    and the true width into `out`. Arguments as posed_epilogue's."""
    zero_bg = np.zeros(4, np.float32)
    kw = dict(feathering=feathering, mask_mode=mask_mode, to_srgb=False,
              raw=False)
    if tier == "target":
        plan, izmin, izmax = solve
        layer = _sweep_target.fetch_finish(
            found, invz_star, poses, packed, izmin, izmax, plan.out_w,
            plan.out_h, zero_bg, **kw)
    elif tier == "scaled":
        plan, f1, fr, dx_user, dy_user, crop_y = solve
        layer = _sweep_scaled.fetch_finish(
            plan, found, invz_star, poses, f1, fr, dx_user, dy_user, crop_y,
            packed, zero_bg, **kw)
    else:
        raise ValueError(f"no epilogue kernel for tier {tier!r}")
    return _composite.over_into(layer, out, background, to_srgb, first=first,
                                last=last)


def posed_epilogue(tier: str, found, invz_star, poses, solve, packed,
                   background, out, *, feathering: float, mask_mode: str,
                   to_srgb: bool, first: bool = True, last: bool = True):
    """Finish one layer of a target or scaled pose chunk into `out`, the
    caller's (B, H, W_true, 4) frames (a slice of the call's output): the
    epilogue kernel for CUDA tensors (one launch, counted in
    `posed_epilogue.launches`), posed_epilogue_plain for CPU tensors.

    found/invz_star: (B, H, W), the tier's depth-only march outputs at its
    width W >= W_true; packed: the layer's (h, w) pack_rgbm texture;
    poses and solve, the tier's pose rows on the device and host numbers:
    'target': the (B, 16) target_pose_scalars rows and (TargetPlan, invz
    min, invz max); 'scaled': the (B, 3) float32 positions c1 and
    (ScaledPlan, f1, fr, dx_user, dy_user, crop_y). background: (4,) host
    values, or a CUDA tensor read on the device. `first`: this is the
    front layer (else `out` holds the layers in front, premultiplied);
    `last`: blend over the background (and sRGB) after it. Returns out."""
    if found.device.type == "cpu":
        return posed_epilogue_plain(
            tier, found, invz_star, poses, solve, packed, background, out,
            feathering=feathering, mask_mode=mask_mode, to_srgb=to_srgb,
            first=first, last=last)
    if tier not in _TIERS:
        raise ValueError(f"no epilogue kernel for tier {tier!r}")
    b, h, w = found.shape
    tex_h, tex_w = packed.shape
    w_true = out.shape[2] if out.ndim == 4 else -1
    _check(found, "found", torch.float32, (b, h, w))
    _check(invz_star, "invz_star", torch.float32, (b, h, w))
    _check(poses, "poses", torch.float32, (b, 16 if tier == "target" else 3))
    _check(packed, "packed", torch.int32, (tex_h, tex_w))
    _check(out, "out", torch.float32, (b, h, w_true, 4))
    if not 0 < w_true <= w:
        raise ValueError(f"a true width of {w_true} does not fit the "
                         f"march's width {w}")
    if mask_mode not in _MASK_MODES:
        raise ValueError(f"unsupported mask_mode: {mask_mode}")
    geom = _geometry(tier, solve, w, h, tex_w, tex_h)
    bg_dev = None
    bg = (0.0, 0.0, 0.0, 0.0)
    if isinstance(background, torch.Tensor) and background.is_cuda:
        # read on the device: no wait on the stream
        bg_dev = background.to(device=found.device,
                                dtype=torch.float32).reshape(4).contiguous()
    else:
        bg = torch.as_tensor(background,
                             dtype=torch.float32).reshape(4).tolist()
    f = max(float(feathering), 1e-6)
    fn = _lib()
    with torch.cuda.device(found.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            _TIERS[tier], found.data_ptr(), invz_star.data_ptr(),
            poses.data_ptr(), packed.data_ptr(),
            None if bg_dev is None else bg_dev.data_ptr(), out.data_ptr(),
            b, h, w, w_true, tex_w, tex_h,
            geom.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), f, 1.0 - f,
            1.0 - (1.0 - f), *bg, _MASK_MODES[mask_mode], int(bool(to_srgb)),
            int(bool(first)), int(bool(last)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"lif_posed_epilogue launch failed: CUDA error {err}")
    posed_epilogue.launches += 1
    return out


posed_epilogue.launches = 0
