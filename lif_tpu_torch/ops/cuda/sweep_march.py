"""The lateral first-crossing march on Hopper: source prep, plane-range
tables and the wrapper of the CUDA kernel csrc/sweep_march.cu.

The counterpart of lif_tpu.ops.pallas.sweep_march, which holds the TPU
kernel this one replaces. What the kernel computes is the same — planes
walked near -> far over the x-shifted source disparity, the first
crossing with its secant bracket (and the optional in-bracket refine
sub-sweep), the color lerp between the warps at planes k-1 and k — but
not the TPU's layout: the source stays row-major with x contiguous (each
plane's shifted read is a coalesced load), one thread marches one (pose,
row, column) pixel, and column clamping replaces the edge padding.

Each lane reads its plane range [k_lo, k_hi) from lif_tpu's (band x
128-row) cell tiling, the same plane_loop_bounds tables (built here by
_skip_tables and lateral_loop_bounds). In place of lif_tpu's per-plane
cm3/occ2 tests, the warps skip whole runs of planes exactly with the row
tables of ops.sweep_march.row_skip_tables (built once per texture by the
renderer, and required by the wrapper).

The kernel's plain version is ops.sweep_march.march_translation_plain
(inside the twin render_translation_plain), and the plain mirror of its
skip walk ops.sweep_march.march_translation_skip_plain; a CUDA tensor
never reaches either from here.

The same library holds the lateral epilogue kernel (lateral_epilogue):
the hit test, taper, mask, premultiply, LDI over-compositing, background
blend and sRGB of one layer of a pose chunk, written into the caller's
output. Its plain version, lateral_epilogue_plain, is the PyTorch chain
it replaces, which the wrapper runs for CPU tensors.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...utils import profiling
from .. import composite as _composite
from ..bounds import plane_loop_bounds
from ..sweep_march import (
    TranslationPlan,
    _edge_pad,
    _finalize,
    _round_up,
    plane_tables,
    warp_shifts,
)
from .build import load_library

__all__ = [
    "SEGMENT_PLANES",
    "lateral_epilogue",
    "lateral_epilogue_plain",
    "lateral_kernel_inputs",
    "lateral_loop_bounds",
    "march_translation_cuda",
    "prepare_translation_src",
    "render_translation_batch_cuda",
    "sweep_lateral",
    "upload_poses",
]

# planes of one shared-memory segment of the kernel's tables (kMaxPlanes):
# a longer ladder is walked segment by segment
SEGMENT_PLANES = 1024
_COARSE = 8  # coarse skip-table cell width, px
_LC = 128  # rows per bounds chunk (lif_tpu's 128-lane y chunk)


def _pick_tw(w: int) -> int:
    """Band width of the bounds cells: the widest of lif_tpu's band
    widths that divides the output width."""
    for tw in (128, 64, 32, 16, 8):
        if w % tw == 0:
            return tw
    raise ValueError(f"output width {w} must be divisible by 8")


def prepare_translation_src(rgb, disp, mask, plan: TranslationPlan):
    """Pose-independent source preparation for the lateral march.

    Returns (src, cm3, cmin3): src the (5, H, W) float32 row-major stack
    [r, g, b, mask, disp] the kernel reads, and the sliding coarse
    max/min disparity tables of the plane-range scan. Pose-chunked
    callers compute this once per call. The source must already be
    center-cropped to the output height."""
    h, w = disp.shape
    if (plan.src_w, plan.src_h) != (w, h) or plan.out_h != h:
        raise ValueError(
            f"plan {plan} does not fit a {w}x{h} source of the output "
            "height (center-crop taller sources first)"
        )
    src = torch.cat(
        [rgb.to(torch.float32).permute(2, 0, 1),
         mask.to(torch.float32)[None], disp.to(torch.float32)[None]],
        dim=0,
    ).contiguous()
    # lif_tpu's padded geometry of the skip tables: x-padded by the plan's
    # left pad and enough right pad for the last band's window (rounded
    # to whole 8-px cells), rows edge-padded to whole 128-row chunks
    tw = _pick_tw(plan.out_w)
    bw = _round_up(plan.tab_span_x + tw + 16, 64)
    pad_hi_x = max(0, (plan.out_w - tw) + bw - w - plan.pad_lo_x)
    pad_hi_x += -(w + plan.pad_lo_x + pad_hi_x) % _COARSE
    disp_p = _edge_pad(
        src[4], (0, _round_up(h, _LC) - h), (plan.pad_lo_x, pad_hi_x)
    )
    cm3, cmin3 = _skip_tables(disp_p, tw)
    return src, cm3, cmin3


def _skip_tables(disp_p, tw: int):
    """Sliding max/min of the coarse disparity cells of the padded
    (Hp, Wp) disparity: (ncells, Hc) tables, cm3[co, c] bounding every
    texel a band's warp can read when its window starts in x-cell co,
    within row chunk c. lif_tpu builds the same tables from its
    transposed stack (its occupancy table occ2 feeds the per-plane skip
    test only, which is not ported)."""
    hp, wp = disp_p.shape
    ncells = wp // _COARSE
    cells = disp_p.reshape(hp // _LC, _LC, ncells, _COARSE)
    span = (tw + 16) // _COARSE + 1  # cells a (tw+17)-px window touches

    def sliding(coarse, reduce):
        t = coarse.transpose(0, 1)  # (ncells, Hc)
        padded = torch.cat([t, t[-1:].expand(span - 1, -1)], dim=0)
        return reduce(padded.unfold(0, span, 1), dim=-1)

    cm3 = sliding(cells.amax(dim=(1, 3)), torch.amax)
    cmin3 = sliding(cells.amin(dim=(1, 3)), torch.amin)
    return cm3, cmin3


def lateral_loop_bounds(cm3, cmin3, ix_t, tkt, out_w: int, num_planes: int):
    """Per-tile plane range (k_lo, k_hi), each (B, nb, Hc) int32, from the
    raw per-plane window starts ix_t (B, K) and texel thresholds tkt
    (B, K) — the scan lif_tpu's _sweep_lateral runs before its launch."""
    tw = _pick_tw(out_w)
    band_cell = torch.arange(
        out_w // tw, dtype=torch.int32, device=ix_t.device
    ) * (tw // _COARSE)
    co_all = band_cell[None, None, :] + (ix_t // _COARSE)[:, :, None]
    return plane_loop_bounds(
        co_all.long(), tkt[:, :, None, None], num_planes,
        gather_max=lambda c: cm3[c],  # (B, K, nb, Hc)
        gather_min=lambda c: cmin3[c],
        ncells=cm3.shape[0],
    )


def _check(t, name, dtype, shape):
    if t is None:
        raise ValueError(f"{name} is required")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_ARGTYPES = (
    # src, ix, fx, izt, klo, khi, r8, r32, found, invz, rgba
    [ctypes.c_void_p] * 11
    + [ctypes.c_int] * 10  # B, K, H, W, out_w, pad_lo_x, tw, n_hc, n8, n32
    + [ctypes.c_float] * 2  # izmin, izmax
    + [ctypes.c_int]  # refine
    + [ctypes.c_void_p]  # stream
)


def _lib():
    lib = load_library("sweep_march")
    fn = lib.lif_lateral_march
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def sweep_lateral(src, ix, fx, izt, klo, khi, izmin: float, izmax: float,
                  plan: TranslationPlan, refine: int = 0, *, rows):
    """Launch the lateral march kernel for a pose batch.

    src: (5, H, W) float32 stack from prepare_translation_src; ix/fx:
    (B, K) int32/float32 warp shifts (warp_shifts of the plane tables);
    izt: (B, K) float32 plane inverse depths, near -> far; klo/khi:
    (B, nb, Hc) int32 plane ranges; rows: (r8, r32) of
    ops.sweep_march.row_skip_tables for src[4] and (izmin, izmax);
    refine: in-bracket sub-planes. Any K >= 1: a ladder longer than
    SEGMENT_PLANES is walked in segments of that many planes. Returns found (B, H, out_w), invz*
    (B, H, out_w) and rgba* (B, H, out_w, 4), float32.
    `sweep_lateral.launches` counts the launches."""
    _, h, w = src.shape
    b, k = ix.shape
    out_w = plan.out_w
    tw = _pick_tw(out_w)
    n_hc = -(-h // _LC)
    _check(src, "src", torch.float32, (5, h, w))
    _check(ix, "ix", torch.int32, (b, k))
    _check(fx, "fx", torch.float32, (b, k))
    _check(izt, "izt", torch.float32, (b, k))
    _check(klo, "klo", torch.int32, (b, out_w // tw, n_hc))
    _check(khi, "khi", torch.int32, (b, out_w // tw, n_hc))
    if (plan.src_w, plan.src_h, plan.out_h) != (w, h, h):
        raise ValueError(f"plan {plan} does not match a {w}x{h} source")
    if k < 1:
        raise ValueError(f"{k} planes: the kernel needs at least one")
    if refine < 0:
        raise ValueError(f"refine {refine} must be >= 0")
    if rows is None:
        raise ValueError("rows is required: row_skip_tables(src[4], izmin, "
                         "izmax)[1:]")
    r8, r32 = rows
    _check(r8, "r8", torch.float32, (h, -(-w // 8)))
    _check(r32, "r32", torch.float32, (h, -(-w // 32)))
    found = torch.empty((b, h, out_w), dtype=torch.float32, device=src.device)
    invz = torch.empty_like(found)
    rgba = torch.empty((b, h, out_w, 4), dtype=torch.float32, device=src.device)
    fn = _lib()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            src.data_ptr(), ix.data_ptr(), fx.data_ptr(), izt.data_ptr(),
            klo.data_ptr(), khi.data_ptr(), r8.data_ptr(), r32.data_ptr(),
            found.data_ptr(), invz.data_ptr(), rgba.data_ptr(),
            b, k, h, w, out_w, plan.pad_lo_x, tw, n_hc, r8.shape[1],
            r32.shape[1], float(izmin), float(izmax), int(refine), stream,
        )
    if err != 0:
        raise RuntimeError(f"lif_lateral_march launch failed: CUDA error {err}")
    sweep_lateral.launches += 1
    return found, invz, rgba


sweep_lateral.launches = 0


def march_translation_cuda(
    rgb,
    disp,
    mask,
    invz_min: float,
    invz_max: float,
    c1,
    f1: float,
    plane_invz,
    plan: TranslationPlan,
    num_planes: int,
    offset=(0.0, 0.0),
    prepared=None,
    refine: int = 0,
    *,
    rows,
    poses=None,
):
    """The lateral march of a pose batch through the kernel: plane tables,
    plane-range tables, one launch. Returns found (B, H, W), invz*
    (B, H, W) and rgba* (B, H, W, 4) — per pose what
    ops.sweep_march.march_translation_plain computes.

    Serves the LATERAL case: c1 (B, 3) host array with c1[:, 1] == 0,
    f1 == f2, source height equal to the output height. plane_invz:
    (B, K) float32 tensor. prepared: prepare_translation_src's pack; rows:
    the (r8, r32) row skip tables of the (cropped) disparity; poses: c1
    already on the device (upload_poses), else uploaded here."""
    if prepared is None:
        prepared = prepare_translation_src(rgb, disp, mask, plan)
    return sweep_lateral(*lateral_kernel_inputs(
        prepared, invz_min, invz_max, c1, f1, plane_invz, plan, num_planes,
        offset=offset, poses=poses,
    ), refine=refine, rows=rows)


def upload_poses(c1, device):
    """The (B, 3) host poses c1 as a float32 tensor on `device`: one
    pageable upload, a wait on the stream."""
    c1_t = torch.as_tensor(np.asarray(c1, np.float32), device=device)
    profiling.host_sync("sync.upload.poses", c1_t.device)
    return c1_t


def lateral_kernel_inputs(prepared, invz_min, invz_max, c1, f1, plane_invz,
                          plan: TranslationPlan, num_planes: int,
                          offset=(0.0, 0.0), poses=None):
    """The arguments of sweep_lateral for a pose batch: warp shifts,
    plane depths and the plane-range tables, from the prepared source
    (prepare_translation_src) and the (B, 3) host poses c1 (poses: the
    same already on the device, else uploaded here)."""
    c1 = np.asarray(c1, np.float32)
    if np.abs(c1[:, 1]).max() > 0.0 or offset[1] != 0.0:
        raise ValueError("the lateral kernel serves x-only translations")
    src, cm3, cmin3 = prepared
    dev = src.device
    izt = plane_invz.to(device=dev, dtype=torch.float32).contiguous()
    c1_t = upload_poses(c1, dev) if poses is None else poses
    ix_t, fx_t, _, _ = plane_tables(plan, izt, c1_t, f1, dx=offset[0])
    izmin, izmax = np.float32(invz_min), np.float32(invz_max)
    # plane thresholds in texel units: texel > tkt <=> decoded d > izt,
    # or texel < tkt where the decode falls as the texel rises: the scan
    # then runs on -disp's tables (its sliding max is -cmin3)
    tkt = (izt - float(izmax)) / float(izmin - izmax)
    if izmin < izmax:
        cm3, cmin3, tkt = -cmin3, -cm3, -tkt
    klo, khi = lateral_loop_bounds(cm3, cmin3, ix_t, tkt, plan.out_w,
                                   num_planes)
    ixw, fxw = warp_shifts(ix_t, fx_t)
    return (src, ixw.contiguous(), fxw.contiguous(), izt, klo.contiguous(),
            khi.contiguous(), izmin, izmax, plan)


def render_translation_batch_cuda(
    rgb,
    disp,
    mask,
    invz_min: float,
    invz_max: float,
    c1,
    f1: float,
    plane_invz,
    background,
    plan: TranslationPlan,
    num_planes: int,
    feathering: float = 0.1,
    mask_mode: str = "none",
    to_srgb: bool = True,
    refine: int = 0,
    raw: bool = False,
    offset=(0.0, 0.0),
    crop_y: int = 0,
    prepared=None,
    *,
    rows,
    out=None,
    first: bool = True,
    last: bool = True,
):
    """The CUDA path of ops.sweep_march.render_translation_batch:
    march_translation_cuda + _finalize (one kernel launch per batch).
    offset: the constant source shift; its x part rides the kernel's warp
    tables, its y part (a skew fold's) must already be pre-applied to the
    source (ops.sweep_march.preshift_source), and the full offset places
    the hit test at the true source position in _finalize.

    out: the caller's (B, H, W_true, 4) frames; given, the epilogue kernel
    (lateral_epilogue, one more launch) finishes this layer into it in
    place of _finalize, over the layers in front unless `first`, over the
    background and to sRGB if `last`, and the poses are uploaded once.
    Returns out."""
    with profiling.span("lif.kernel.lateral"):
        poses = upload_poses(c1, disp.device) if out is not None else None
        found, invz_star, rgba_star = march_translation_cuda(
            rgb, disp, mask, invz_min, invz_max, c1, f1, plane_invz, plan,
            num_planes, offset=(offset[0], 0.0), prepared=prepared,
            refine=refine, rows=rows, poses=poses,
        )
    with profiling.span("lif.epilogue.lateral"):
        if out is not None:
            profiling.count("epilogue.lateral.fused")
            if not first:
                profiling.count("epilogue.lateral.behind")
            return lateral_epilogue(
                found, invz_star, rgba_star, poses, plan, f1, background,
                out, feathering=feathering, mask_mode=mask_mode,
                to_srgb=to_srgb, offset=offset, crop_y=crop_y, first=first,
                last=last,
            )
        c1_t = torch.as_tensor(np.asarray(c1, np.float32),
                               device=found.device)
        profiling.host_sync("sync.upload.poses", found.device)
        return _finalize(
            plan, found, invz_star, rgba_star, c1_t, f1, background,
            feathering, mask_mode, to_srgb, raw=raw, offset=offset,
            crop_y=crop_y,
        )


_MASK_MODES = {"none": 0, "multiply": 1, "hard": 2}

_EPILOGUE_ARGTYPES = (
    # found, invz, rgba, c1, background (or None), out
    [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 4  # B, H, W (the march's), W_true
    + [ctypes.c_double] * 5  # f1, bx, by, offset x, offset y
    + [ctypes.c_int] * 3  # crop_y, src_w, src_h + 2 crop_y
    + [ctypes.c_double] * 3  # feathering f, 1 - f, 1 - (1 - f)
    + [ctypes.c_float] * 4  # the background, unless on the device
    + [ctypes.c_int] * 4  # mask mode, to_srgb, first, last
    + [ctypes.c_void_p]  # stream
)


def _epilogue_lib():
    lib = load_library("sweep_march")
    fn = lib.lif_lateral_epilogue
    if fn.argtypes is None:
        fn.argtypes = _EPILOGUE_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def lateral_epilogue_plain(found, invz_star, rgba_star, c1,
                           plan: TranslationPlan, f1: float, background,
                           out, *, feathering: float, mask_mode: str,
                           to_srgb: bool, offset=(0.0, 0.0), crop_y: int = 0,
                           first: bool = True, last: bool = True):
    """The epilogue kernel's plain version, on any device: the PyTorch
    chain it replaces, operator for operator. _finalize over a zero
    background (as _layer_tier_batch renders each layer), the front-to-back
    over of models/renderer.py::_fast_batch_core onto the layers in front
    held in `out` (unless `first`), finish_over_background (if `last`),
    then the true width into `out` (composite.over_into, at the march's
    padded width)."""
    layer = _finalize(plan, found, invz_star, rgba_star, c1, f1,
                      np.zeros(4, np.float32), feathering, mask_mode, False,
                      offset=offset, crop_y=crop_y)
    return _composite.over_into(layer, out, background, to_srgb, first=first,
                                last=last)


def lateral_epilogue(found, invz_star, rgba_star, c1, plan: TranslationPlan,
                     f1: float, background, out, *, feathering: float,
                     mask_mode: str, to_srgb: bool, offset=(0.0, 0.0),
                     crop_y: int = 0, first: bool = True, last: bool = True):
    """Finish one layer of a lateral pose chunk into `out`, the caller's
    (B, H, W_true, 4) frames (a slice of the call's output): the epilogue
    kernel for CUDA tensors (one launch, counted in
    `lateral_epilogue.launches`), lateral_epilogue_plain for CPU tensors.

    found/invz_star: (B, H, W) and rgba_star (B, H, W, 4), the march's
    outputs at its padded width W = plan.out_w >= W_true; c1: the (B, 3)
    float32 poses on the device; background: (4,) host values, or a CUDA
    tensor read on the device; offset and crop_y as _finalize takes them.
    `first`: this is the front layer (else `out` holds the layers in
    front, premultiplied); `last`: blend over the background (and sRGB)
    after it. Returns out."""
    if found.device.type == "cpu":
        return lateral_epilogue_plain(
            found, invz_star, rgba_star, c1, plan, f1, background, out,
            feathering=feathering, mask_mode=mask_mode, to_srgb=to_srgb,
            offset=offset, crop_y=crop_y, first=first, last=last)
    b, h, w = found.shape
    w_true = out.shape[2] if out.ndim == 4 else -1
    _check(found, "found", torch.float32, (b, h, w))
    _check(invz_star, "invz_star", torch.float32, (b, h, w))
    _check(rgba_star, "rgba_star", torch.float32, (b, h, w, 4))
    _check(c1, "c1", torch.float32, (b, 3))
    _check(out, "out", torch.float32, (b, h, w_true, 4))
    if (plan.out_w, plan.out_h) != (w, h) or not 0 < w_true <= w:
        raise ValueError(f"plan {plan} and a true width of {w_true} do not "
                         f"fit the march's {w}x{h} outputs")
    if mask_mode not in _MASK_MODES:
        raise ValueError(f"unsupported mask_mode: {mask_mode}")
    bg_dev = None
    bg = (0.0, 0.0, 0.0, 0.0)
    on_card = (isinstance(background, torch.Tensor)
               and background.device.type == "cuda")
    if on_card:  # read on the device: no wait on the stream
        bg_dev = background.to(device=found.device,
                                dtype=torch.float32).reshape(4).contiguous()
    else:
        bg = torch.as_tensor(background,
                             dtype=torch.float32).reshape(4).tolist()
    f = max(float(feathering), 1e-6)
    fn = _epilogue_lib()
    with torch.cuda.device(found.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            found.data_ptr(), invz_star.data_ptr(), rgba_star.data_ptr(),
            c1.data_ptr(), None if bg_dev is None else bg_dev.data_ptr(),
            out.data_ptr(), b, h, w, w_true, float(f1),
            (plan.src_w - plan.out_w) / 2.0, (plan.src_h - plan.out_h) / 2.0,
            float(offset[0]), float(offset[1]), int(crop_y), plan.src_w,
            plan.src_h + 2 * int(crop_y), f, 1.0 - f, 1.0 - (1.0 - f), *bg,
            _MASK_MODES[mask_mode], int(bool(to_srgb)), int(bool(first)),
            int(bool(last)), stream,
        )
    if err != 0:
        raise RuntimeError(
            f"lif_lateral_epilogue launch failed: CUDA error {err}")
    lateral_epilogue.launches += 1
    return out


lateral_epilogue.launches = 0
