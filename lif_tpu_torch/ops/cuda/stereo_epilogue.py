"""The stereo epilogue on Hopper: the wrapper of the CUDA kernel
csrc/stereo_epilogue.cu, and the stretch-mark confidence it computes.

What follows both eyes' lateral marches of one LDI layer of a pose chunk
of the fast stereo path (models/renderer.py::render_stereo_fast_batch),
finished into the caller's frames: for each eye the hit test at the true
source position with the edge taper and mask, and the stretch-mark
confidence (stretch_conf); then ops/stereo.py's occlusion fill and
baseline blend, composite.over onto the layers in front and, on the last
layer, the background and sRGB. It replaces no TPU kernel (lif_tpu leaves
the stage to XLA's fusion); in the port it replaces a chain of PyTorch
operators and concatenations, which is its plain version,
stereo_epilogue_plain, and which the wrapper runs for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ...core.transforms import inv3, mat_from_focal, mm, shader_rotation
from ...utils import profiling
from .. import composite as _composite
from .. import stereo as _stereo
from ..sampling import read_disp
from ..sweep_march import TranslationPlan, _finalize
from .build import load_library
from .sweep_march import _MASK_MODES, _check

__all__ = ["StereoEye", "blend_over_into", "conf_step", "conf_transforms",
           "stereo_epilogue", "stereo_epilogue_plain", "stretch_conf"]

_F32 = np.float32
_ZERO_BG = np.zeros(4, np.float32)

# the kernel's Eye record: the march outputs', poses', transforms' and
# disparity texture's pointers, the texture's dims and row stride, the hit
# test's float32 numbers (f1, bx, by, offset x, offset y, crop_y,
# 1 / src_w, 1 / (src_h + 2 crop_y)) and the confidence's (float(ws),
# float(hs), the read's clamp bounds of u and of v, the shift over the
# dims, dv, 2.8 dv, the decode's scale and offset)
_EYE = np.dtype([("ptr", "<u8", (6,)), ("dims", "<i4", (4,)),
                 ("geom", "<f4", (8,)), ("conf", "<f4", (12,))])
assert _EYE.itemsize == 144


class StereoEye(NamedTuple):
    """One eye of one layer of a stereo pose chunk: the lateral march's
    outputs (no width pad), found and invz_star (B, H, W) and rgba_star
    (B, H, W, 4), float32; poses, the eye's (B, 3) float32 positions; the
    hit test's numbers as _finalize takes them (the march's plan, the
    source focal f1, the constant source offset and the outpaint crop);
    and the confidence's: the layer's (hs, ws) disparity texture, its
    inverse-depth range (host numbers) and `transforms`, the (B, 12)
    float32 rows of conf_transforms (p row-major, then c_vec), all on one
    device."""

    found: torch.Tensor
    invz_star: torch.Tensor
    rgba_star: torch.Tensor
    poses: torch.Tensor
    plan: TranslationPlan
    f1: float
    offset: tuple
    crop_y: int
    disp: torch.Tensor
    invz_min: float
    invz_max: float
    transforms: torch.Tensor


def conf_step(out_w: int, out_h: int) -> int:
    """The confidence grid's step: every 4th pixel where the output dims
    divide by 4, else every 2nd, else every pixel."""
    if out_h % 4 == 0 and out_w % 4 == 0:
        return 4
    return 2 if out_h % 2 == 0 and out_w % 2 == 0 else 1


def conf_transforms(f1, ws, hs, c1_b, rot_b, f2, out_w, out_h):
    """stretch_conf's per-pose source transforms, float32 on the host:
    p (B, 3, 3), the output pixel grid to the source's normalized ray, and
    c_vec (B, 3), the source-frame offset of each pose's camera."""
    f1, f2 = _F32(f1), _F32(f2)
    fskr1 = mm(mat_from_focal(f1 / _F32(ws), f1 / _F32(hs)),
               shader_rotation(np.asarray(rot_b, np.float32)))
    p = mm(fskr1, inv3(mat_from_focal(f2 / _F32(out_w), f2 / _F32(out_h))))
    c_vec = (fskr1 @ -torch.as_tensor(np.asarray(c1_b, np.float32))[..., None])
    return p, c_vec[..., 0]


def stretch_conf(disp, invz_min, invz_max, doff, p, c_vec, hit, invz, out_w,
                 out_h):
    """The exact march's stretch-mark confidence for a fast tier's raw
    solution (lif_tpu's _stretch_conf). The exact kernel's occlusion fill
    keys on the march's confidence, zeroed where a crossing step saw a
    disparity jump above grad_thr (rayCastMonoLDI.glsl:236, 265-267):
    per production step (range / 40) that is a slope of 0.02 * 140 =
    2.8. So the disparity is read at the solved crossing and one step dv
    in front of it along the exact ray s1(v) = q + v (c - c_z q), and
    confidence dies where the two differ by more than 2.8 dv, on hit
    pixels. Evaluated on a coarse grid (conf_step), at each block's first
    pixel, and nearest-upsampled. The skew fold's constant shift `doff`
    moves the probes. disp: the layer's (hs, ws) disparity texture; p
    (B, 3, 3) and c_vec (B, 3): conf_transforms' on disp's device; hit
    and invz: the tier's raw (B, H, W) outputs. Returns (B, H, W) float32
    confidence, 0 or 1."""
    hs, ws = disp.shape
    dev = disp.device
    izmin, izmax = _F32(invz_min), _F32(invz_max)
    ds = conf_step(out_w, out_h)
    jx = (torch.arange(out_w // ds, dtype=torch.float32, device=dev) * ds
          + 0.5) / out_w - 0.5
    iy = (torch.arange(out_h // ds, dtype=torch.float32, device=dev) * ds
          + 0.5) / out_h - 0.5
    s2x, s2y = jx[None, None, :], iy[None, :, None]
    p, c_vec = p[..., None, None], c_vec[..., None, None]
    den = p[:, 2, 0] * s2x + p[:, 2, 1] * s2y + p[:, 2, 2]
    qx = (p[:, 0, 0] * s2x + p[:, 0, 1] * s2y + p[:, 0, 2]) / den
    qy = (p[:, 1, 0] * s2x + p[:, 1, 1] * s2y + p[:, 1, 2]) / den
    dsx = c_vec[:, 0] - c_vec[:, 2] * qx
    dsy = c_vec[:, 1] - c_vec[:, 2] * qy
    dxp = float(_F32(doff[0]) / _F32(ws))
    dyp = float(_F32(doff[1]) / _F32(hs))
    dv = (izmin - izmax) / _F32(40.0)

    def disp_at(v):
        return read_disp(disp, qx + v * dsx + 0.5 + dxp,
                         qy + v * dsy + 0.5 + dyp, float(izmin),
                         float(izmax), ws, hs)

    invz_c = invz[:, ::ds, ::ds]
    kill = (torch.abs(disp_at(invz_c) - disp_at(invz_c + float(dv)))
            > float(_F32(2.8) * dv))
    kill = kill.repeat_interleave(ds, 1).repeat_interleave(ds, 2)
    return torch.where(kill & (hit > 0.5), 0.0, 1.0)


def blend_over_into(views, confs, w_r, out, background, to_srgb: bool, *,
                    first: bool, last: bool):
    """The stereo chain's tail for one layer, written into `out`, the
    caller's (B, H, W, 4) frames: each eye's view (its straight colour and
    alpha), ops.stereo.occlusion_blend with the (B,) weights w_r,
    composite.over onto the layers in front, held premultiplied in `out`
    (unless `first`), then finish_over_background (if `last`). views: the
    left and right eyes' raw tier finishes (rgba (B, H, W, 4), alpha (B,
    H, W)); confs: their (B, H, W) stretch-mark confidences. The stereo
    epilogue's plain version ends here, and so does each layer of the
    chain that a non-lateral eye keeps. Returns out."""
    blend = _stereo.occlusion_blend(
        *(torch.cat([rgba[..., :3], alpha[..., None]], dim=-1)
          for rgba, alpha in views), *confs, w_r[:, None, None, None])
    acc = None if first else (out[..., :3], out[..., 3])
    with profiling.span("lif.composite"):
        rgb, a = _composite.over(acc, blend)
        if last:
            done = _composite.finish_over_background(rgb, a, background,
                                                     to_srgb)
        else:
            done = torch.cat([rgb, a[..., None]], dim=-1)
        out.copy_(done)
    return out


def stereo_epilogue_plain(eyes, w_r, out, *, background, feathering: float,
                          mask_mode: str, to_srgb: bool, first: bool = True,
                          last: bool = True):
    """The kernel's plain version, on any device: the PyTorch chain it
    replaces, operator for operator. For each of the two StereoEyes,
    _finalize(raw=True) and stretch_conf on its transforms; then
    blend_over_into `out`, the caller's (B, H, W, 4) frames, with the (B,)
    weights w_r. Returns out."""
    h, w = out.shape[1:3]
    views, confs = [], []
    for eye in eyes:
        rgba, alpha, hit, invz = _finalize(
            eye.plan, eye.found, eye.invz_star, eye.rgba_star, eye.poses,
            eye.f1, _ZERO_BG, feathering, mask_mode, False, raw=True,
            offset=eye.offset, crop_y=eye.crop_y)
        views.append((rgba, alpha))
        with profiling.span("lif.stereo.conf"):
            tf = eye.transforms
            confs.append(stretch_conf(
                eye.disp, eye.invz_min, eye.invz_max, eye.offset,
                tf[:, :9].reshape(-1, 3, 3), tf[:, 9:], hit, invz, w, h))
    return blend_over_into(views, confs, w_r, out, background, to_srgb,
                           first=first, last=last)


_ARGTYPES = (
    [ctypes.c_void_p] * 4  # the host eye records, w_r, background (or
    # None), out
    + [ctypes.c_int] * 4  # B, H, W, ds
    + [ctypes.c_double] * 3  # feathering f, 1 - f, 1 - (1 - f)
    + [ctypes.c_float] * 4  # the background, unless on the device
    + [ctypes.c_int] * 4  # mask mode, to_srgb, first, last
    + [ctypes.c_void_p]  # stream
)


def _lib():
    lib = load_library("stereo_epilogue")
    fn = lib.lif_stereo_epilogue
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_eye(eye, b, h, w):
    """Raise ValueError for an eye-layer the kernel does not take."""
    _check(eye.found, "found", torch.float32, (b, h, w))
    _check(eye.invz_star, "invz_star", torch.float32, (b, h, w))
    _check(eye.rgba_star, "rgba_star", torch.float32, (b, h, w, 4))
    _check(eye.poses, "poses", torch.float32, (b, 3))
    _check(eye.transforms, "transforms", torch.float32, (b, 12))
    disp = eye.disp
    if (disp.ndim != 2 or disp.device.type != "cuda"
            or disp.dtype != torch.float32 or disp.stride(1) != 1):
        raise ValueError("disp must be a (hs, ws) float32 CUDA tensor with "
                         f"contiguous rows, got {tuple(disp.shape)} "
                         f"{disp.dtype} on {disp.device}")
    if (eye.plan.out_w, eye.plan.out_h) != (w, h):
        raise ValueError(f"plan {eye.plan} does not fit the {w}x{h} output: "
                         "the stereo march has no width pad")


def _eye_table(eyes) -> np.ndarray:
    """The kernel's two Eye records (_EYE), left then right."""
    rec = np.zeros(2, _EYE)
    for k, eye in enumerate(eyes):
        plan, crop_y = eye.plan, int(eye.crop_y)
        hs, ws = eye.disp.shape
        izmin, izmax = _F32(eye.invz_min), _F32(eye.invz_max)
        bu, bv = _F32(2.0) / _F32(ws), _F32(2.0) / _F32(hs)
        dv = (izmin - izmax) / _F32(40.0)
        rec[k] = ((eye.found.data_ptr(), eye.invz_star.data_ptr(),
                   eye.rgba_star.data_ptr(), eye.poses.data_ptr(),
                   eye.transforms.data_ptr(), eye.disp.data_ptr()),
                  (ws, hs, eye.disp.stride(0), 0),
                  (float(eye.f1), (plan.src_w - plan.out_w) / 2.0,
                   (plan.src_h - plan.out_h) / 2.0, float(eye.offset[0]),
                   float(eye.offset[1]), crop_y,
                   _F32(1.0) / _F32(plan.src_w),
                   _F32(1.0) / _F32(plan.src_h + 2 * crop_y)),
                  (ws, hs, bu, _F32(1.0) - bu, bv, _F32(1.0) - bv,
                   _F32(eye.offset[0]) / _F32(ws),
                   _F32(eye.offset[1]) / _F32(hs), dv, _F32(2.8) * dv,
                   izmin - izmax, izmax))
    return rec


def stereo_epilogue(eyes, w_r, out, *, background, feathering: float,
                    mask_mode: str, to_srgb: bool, first: bool = True,
                    last: bool = True):
    """Finish one layer of a stereo pose chunk into `out`, the caller's
    (B, H, W, 4) frames (a slice of the call's output): the stereo
    epilogue kernel for CUDA tensors (one launch, counted in
    `stereo_epilogue.launches`), stereo_epilogue_plain for CPU tensors.

    eyes: the left and right StereoEye; w_r: the (B,) float32 weights of
    the right view on the same device; background: (4,) host values, or a
    CUDA tensor read on the device. `first`: this is the front layer (else
    `out` holds the layers in front, premultiplied); `last`: blend over
    the background (and sRGB) after it. Returns out."""
    if out.device.type == "cpu":
        return stereo_epilogue_plain(
            eyes, w_r, out, background=background, feathering=feathering,
            mask_mode=mask_mode, to_srgb=to_srgb, first=first, last=last)
    eyes = list(eyes)
    if len(eyes) != 2:
        raise ValueError(f"the stereo epilogue takes two eyes, got "
                         f"{len(eyes)}")
    if mask_mode not in _MASK_MODES:
        raise ValueError(f"unsupported mask_mode: {mask_mode}")
    b, h, w = out.shape[:3]
    if b > 65535:
        raise ValueError(f"{b} poses: the kernel takes at most 65535 a launch")
    _check(out, "out", torch.float32, (b, h, w, 4))
    _check(w_r, "w_r", torch.float32, (b,))
    for eye in eyes:
        _check_eye(eye, b, h, w)
    table = _eye_table(eyes)
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
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            table.ctypes.data, w_r.data_ptr(),
            None if bg_dev is None else bg_dev.data_ptr(), out.data_ptr(), b,
            h, w, conf_step(w, h), f, 1.0 - f, 1.0 - (1.0 - f), *bg,
            _MASK_MODES[mask_mode], int(bool(to_srgb)), int(bool(first)),
            int(bool(last)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"lif_stereo_epilogue launch failed: CUDA error {err}")
    stereo_epilogue.launches += 1
    return out


stereo_epilogue.launches = 0
