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
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...utils import profiling
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
    "lateral_kernel_inputs",
    "lateral_loop_bounds",
    "march_translation_cuda",
    "prepare_translation_src",
    "render_translation_batch_cuda",
    "sweep_lateral",
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
):
    """The lateral march of a pose batch through the kernel: plane tables,
    plane-range tables, one launch. Returns found (B, H, W), invz*
    (B, H, W) and rgba* (B, H, W, 4) — per pose what
    ops.sweep_march.march_translation_plain computes.

    Serves the LATERAL case: c1 (B, 3) host array with c1[:, 1] == 0,
    f1 == f2, source height equal to the output height. plane_invz:
    (B, K) float32 tensor. prepared: prepare_translation_src's pack; rows:
    the (r8, r32) row skip tables of the (cropped) disparity."""
    if prepared is None:
        prepared = prepare_translation_src(rgb, disp, mask, plan)
    return sweep_lateral(*lateral_kernel_inputs(
        prepared, invz_min, invz_max, c1, f1, plane_invz, plan, num_planes,
        offset=offset,
    ), refine=refine, rows=rows)


def lateral_kernel_inputs(prepared, invz_min, invz_max, c1, f1, plane_invz,
                          plan: TranslationPlan, num_planes: int,
                          offset=(0.0, 0.0)):
    """The arguments of sweep_lateral for a pose batch: warp shifts,
    plane depths and the plane-range tables, from the prepared source
    (prepare_translation_src) and the (B, 3) host poses c1."""
    c1 = np.asarray(c1, np.float32)
    if np.abs(c1[:, 1]).max() > 0.0 or offset[1] != 0.0:
        raise ValueError("the lateral kernel serves x-only translations")
    src, cm3, cmin3 = prepared
    dev = src.device
    izt = plane_invz.to(device=dev, dtype=torch.float32).contiguous()
    c1_t = torch.as_tensor(c1, device=dev)
    profiling.host_sync("sync.upload.poses", dev)
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
):
    """The CUDA path of ops.sweep_march.render_translation_batch:
    march_translation_cuda + _finalize (one kernel launch per batch).
    offset: the constant source shift; its x part rides the kernel's warp
    tables, its y part (a skew fold's) must already be pre-applied to the
    source (ops.sweep_march.preshift_source), and the full offset places
    the hit test at the true source position in _finalize."""
    with profiling.span("lif.kernel.lateral"):
        found, invz_star, rgba_star = march_translation_cuda(
            rgb, disp, mask, invz_min, invz_max, c1, f1, plane_invz, plan,
            num_planes, offset=(offset[0], 0.0), prepared=prepared,
            refine=refine, rows=rows,
        )
    with profiling.span("lif.epilogue.lateral"):
        c1_t = torch.as_tensor(np.asarray(c1, np.float32),
                               device=found.device)
        profiling.host_sync("sync.upload.poses", found.device)
        return _finalize(
            plan, found, invz_star, rgba_star, c1_t, f1, background,
            feathering, mask_mode, to_srgb, raw=raw, offset=offset,
            crop_y=crop_y,
        )
