"""Renderer: render-mode dispatch from (projector, camera) to images.

The counterpart of lif_tpu.models.renderer for the slice the port has so
far: the exact ray march (render_mono_view, render(mode='raycast')) and
the production fast path render_fast_batch on four tiers —
  * 'march': LATERAL pose batches, the snap-plane first-crossing march
    (on CUDA through csrc/sweep_march.cu);
  * 'scaled': other UNROTATED batches (y/z translation, dolly, zoom) and
    lateral layers the march cannot take, the scaled first-crossing march
    plus one packed color fetch (on CUDA through csrc/sweep_scaled.cu);
  * 'target': rotated YAW-family pose batches (the orbit), the
    single-phase target-ray march (on CUDA through csrc/sweep_target.cu),
    and PITCH-family batches through an x<->y transpose onto it;
  * 'rotated': the two-phase fallback for other rotated batches, phase A
    on the scaled march (csrc/sweep_scaled.cu), phase B plain torch.
The mesh modes: render(mode='billboard') is the billboard scatter
(ops/splat.py) and render(mode='mesh') the connected-mesh rasterizer
(ops/mesh.py), both plain torch on any device; render_billboard_fast_batch
renders a lateral pose batch in billboard mode through the row z-buffer
scatter (on CUDA through csrc/splat_march.cu, one launch per batch; on
the CPU its plain version billboard_scatter_plain).
A pose, layer or option that needs what the port does not have yet (the
'sweep' fallback, the skewed lateral fold, ...) raises
NotImplementedError naming it; nothing falls back to an approximate tier.

Host-side planning (relative poses, plane grids, pad plans, the tiers'
extents and pose packs) runs in numpy; the textures and every per-pixel
operation stay on the projector's device.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, RenderConfig
from ..core.camera import Camera
from ..core.pose import relative_view_pose
from ..ops import composite as _composite
from ..ops import mesh as _mesh
from ..ops import raycast as _raycast
from ..ops import rotated_march as _rotated_march
from ..ops import splat as _splat
from ..ops import splat_march as _splat_march
from ..ops import sweep_march as _sweep_march
from ..ops import sweep_scaled as _sweep_scaled
from ..ops import sweep_target as _sweep_target
from ..ops.cuda.sweep_march import prepare_translation_src
from ..ops.cuda.sweep_target import skip_table_buffer
from .projector import Projector

__all__ = ["BillboardPlan", "TierPlan", "plan_billboard", "plan_tiers",
           "render", "render_billboard_fast_batch", "render_fast_batch",
           "render_mono_view"]

# Two caches for the fast path, both LRU. The TEXTURE cache holds the
# pose-independent per-layer views, host scalars and the kernels' skip
# tables once per projector; it keys on the identity of the texture
# tensors plus their in-place version counters and on the host fields the
# entry bakes in, and stores strong references so the ids stay valid. The
# TABLE cache holds the per-pose snap-plane grids on the device: building
# them is host numpy per pose, which a replayed trajectory must not pay
# every frame.
_TEX_CACHE: OrderedDict = OrderedDict()
_TEX_CACHE_MAX = 16
_TABLE_CACHE: OrderedDict = OrderedDict()
_TABLE_CACHE_MAX = 64

# target-tier plans memoized on the exact pose batch (and device): the
# entries hold the per-pose ladders and pose packs on the device, so a
# hit also skips the uploads. "ineligible" caches the planner's
# ValueError (the decision to route the batch to the rotated tier).
_TARGET_PLAN_CACHE: OrderedDict = OrderedDict()
_TARGET_PLAN_CACHE_MAX = 8
# L2: target-tier plans keyed on BUCKETED window extents, so a novel
# camera inside a previously planned pose neighborhood pays only the
# sub-ms extent measurement plus its per-pose ladders and pose packs
_TARGET_NEIGHBORHOOD_CACHE: OrderedDict = OrderedDict()
_TARGET_NEIGHBORHOOD_CACHE_MAX = 32
# transposed-route eligibility, keyed on bucketed transposed extents
_TARGET_OK_CACHE: OrderedDict = OrderedDict()
_TARGET_OK_CACHE_MAX = 64
# axis-swapped projectors of the pitch route (textures transposed once)
_TRANSPOSED_CACHE: OrderedDict = OrderedDict()
_TRANSPOSED_CACHE_MAX = 8

# x<->y axis swap: transposing every image conjugates all camera-space
# quantities by this permutation. Applied by INDEXING, so it is exact.
_SWAP_XY = (1, 0, 2)


class _TierNotPorted(NotImplementedError):
    """A layer routed to a tier the port does not have; `tier` names it."""

    def __init__(self, tier: str, why: str):
        super().__init__(
            f"{why}: this needs the '{tier}' tier, which is not ported yet"
        )
        self.tier = tier


def _lru_put(cache: OrderedDict, limit: int, key, value):
    cache[key] = value
    while len(cache) > limit:
        cache.popitem(last=False)


def _disp_fingerprint(buf: torch.Tensor) -> int:
    """Mutation check of a texture tensor: its version counter, which
    every in-place write bumps (lif_tpu samples mutable host buffers
    instead; its jax arrays are immutable)."""
    return buf._version


def _texture_key(projector):
    """Cache key + strong-reference tuple covering everything a prepared
    entry bakes in: the texture buffers (identity and in-place version
    counter) and the host fields focal, invz_min/invz_max, baseline and
    layer_res (numpy, so reading them costs no device sync). A projector
    made with dataclasses.replace keeps the textures of the first one and
    must still miss when one of those fields differs."""
    refs = (projector.disp, projector.rgb, projector.mask)
    key = tuple((id(buf), _disp_fingerprint(buf)) for buf in refs) + tuple(
        np.asarray(field).tobytes()
        for field in (projector.focal, projector.invz_min, projector.invz_max,
                      projector.baseline, projector.layer_res)
    )
    return key, refs


def _layer_skip(disp, izmin, izmax):
    """The march kernels' skip tables of one layer's disparity, built once
    per CUDA texture by each kernel's builder: the target kernel's flat
    buffer, the scaled kernel's skip_pack (which reuses that buffer where
    it can) and the lateral kernel's (r8, r32) row tables. A CPU texture
    takes the plain marches, which read none of them."""
    if disp.device.type != "cuda":
        return {}
    target = skip_table_buffer(disp)
    return dict(
        skip_target=target,
        skip_scaled=_sweep_scaled.skip_pack(disp, izmin, izmax,
                                            target=target),
        skip_rows=_sweep_march.row_skip_tables(disp, izmin, izmax)[1:],
    )


def _prepared_textures(projector):
    """Pose-independent per-layer constants, cached once per projector:
    texture views on the device, baseline-normalized ranges, the host
    scalars the planners read and the kernels' skip tables (_layer_skip).
    Returns a list of per-layer dicts."""
    key, refs = _texture_key(projector)
    hit = _TEX_CACHE.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], refs)):
        _TEX_CACHE.move_to_end(key)
        return hit[1]

    baseline = float(projector.baseline)
    layers = []
    for i in range(projector.num_layers):
        w_i = int(projector.layer_res[i, 0])
        h_i = int(projector.layer_res[i, 1])
        izmin = float(projector.invz_min[i]) / baseline
        izmax = float(projector.invz_max[i]) / baseline
        disp = projector.disp[i, :h_i, :w_i]
        layers.append(
            dict(
                rgb=projector.rgb[i, :h_i, :w_i],
                disp=disp,
                mask=projector.mask[i, :h_i, :w_i],
                focal_host=float(projector.focal[i]),
                izmin_host=izmin,
                izmax_host=izmax,
                w=w_i,
                h=h_i,
                **_layer_skip(disp.to(torch.float32), izmin, izmax),
            )
        )
    while len(_TEX_CACHE) >= _TEX_CACHE_MAX:
        _TEX_CACHE.popitem(last=False)
    _TEX_CACHE[key] = (refs, layers)
    return layers


def _snap_tables(lay, cxs, explicit_planes, phase_px, stride, device):
    """Per-pose snap-plane grids (B, K) on `device` plus K, memoized on
    the exact pose batch (the counterpart of lif_tpu's per-(num_planes,
    mode) plane-table cache; the port has only the snap mode)."""
    key = (
        lay["focal_host"], lay["izmin_host"], lay["izmax_host"],
        np.asarray(cxs, np.float64).tobytes(), explicit_planes,
        float(phase_px), int(stride), str(device),
    )
    hit = _TABLE_CACHE.get(key)
    if hit is not None:
        _TABLE_CACHE.move_to_end(key)
        return hit
    tab, k = _sweep_march.snap_plane_tables_batch(
        lay["focal_host"], [float(c) for c in cxs],
        lay["izmin_host"], lay["izmax_host"],
        num_planes=explicit_planes, phase_px=phase_px, stride=stride,
    )
    entry = (torch.as_tensor(tab, device=device), k)
    while len(_TABLE_CACHE) >= _TABLE_CACHE_MAX:
        _TABLE_CACHE.popitem(last=False)
    _TABLE_CACHE[key] = entry
    return entry


def _march_eligible(lay, f2_host, out_w, out_h, out_w_true=None):
    """Per-layer march eligibility (matched focal; dims equal to the
    output or larger by an EVEN outpaint margin). Non-8-divisible output
    widths are handled by the caller's pad-and-slice (_width_pad): it
    passes the PADDED width as out_w and the true width as out_w_true;
    geometry is checked against the true width."""
    out_w_true = out_w if out_w_true is None else out_w_true
    return (
        abs(lay["focal_host"] - f2_host) < 1e-6 * f2_host
        and out_w % 8 == 0
        and lay["w"] >= out_w_true
        and lay["h"] >= out_h
        and (lay["w"] - out_w_true) % 2 == 0
        and (lay["h"] - out_h) % 2 == 0
    )


def _width_pad(out_w: int) -> int:
    """Extra output columns so the band tiling divides the width. The
    padded render equals the wide-camera render shifted by wpad/2 px (bx
    drops by wpad/2; the constant dx offset restores it), so slicing the
    first out_w columns reproduces the unpadded render exactly —
    including snap-grid exactness, since bx_eff + wpad/2 == bx."""
    return (-out_w) % 8


def _march_plan(lay, max_cx, out_w, out_h, phase_abs=0.0):
    """The march's pad-plan recipe. Caps the plan: a shift beyond
    src+out width puts every plane fully outside the source (alpha 0),
    so larger pads only waste memory on extreme poses. phase_abs:
    |constant shift| to cover (plus a safety pixel)."""
    max_shift = min(
        lay["focal_host"] * max_cx * lay["izmin_host"]
        + (abs(phase_abs) + 1.0 if phase_abs else 0.0),
        float(lay["w"] + out_w),
    )
    return _sweep_march.translation_plan(
        lay["w"], lay["h"], out_w, out_h, max_shift, 0.0
    )


def _march_sources(lay, plan, crop_y):
    """The march tier's source pipeline: the center crop of a taller
    (outpainted) layer to the output height."""
    rgb_l, disp_l, mask_l = lay["rgb"], lay["disp"], lay["mask"]
    if crop_y:
        rows = slice(crop_y, crop_y + plan.out_h)
        rgb_l, disp_l, mask_l = rgb_l[rows], disp_l[rows], mask_l[rows]
    return rgb_l, disp_l, mask_l


def _attach_march_prep(layers, modes, plans, crops):
    """Hoist the march's pose-independent source prep (the kernel's source
    stack + plane-range tables) out of the pose-chunk loop: computed ONCE
    per call, for 'march' layers, with the rows of the cached row skip
    tables the crop keeps. CUDA path only (the CPU twin reads the raw
    textures)."""
    out = []
    for lay, mode, plan, crop_y in zip(layers, modes, plans, crops):
        if mode != "march" or lay["disp"].device.type != "cuda":
            out.append(lay)
            continue
        rows = slice(crop_y, crop_y + plan.out_h)
        out.append(dict(
            lay,
            march_prep=prepare_translation_src(
                *_march_sources(lay, plan, crop_y), plan
            ),
            march_rows=tuple(t[rows] for t in lay["skip_rows"]),
        ))
    return out


def _balanced_chunk(batch, pose_chunk):
    """Balanced pose-chunk size: ceil(batch / n_chunks) for the chunk
    count the nominal size implies — e.g. batch=120 at pose_chunk=48
    renders 3 x 40 instead of 48 + 48 + 24."""
    if not pose_chunk or batch <= pose_chunk:
        return pose_chunk
    n_chunks = -(-batch // pose_chunk)
    return -(-batch // n_chunks)


def _plan_target_entry(lay, f2_host, out_w, out_h, rot_list, pos_list, cfg,
                       explicit_planes, device):
    """The target tier's setup for one layer, or None when the planner
    rejects the batch (not yaw-family, or outside lif_tpu's budgets).
    The plan is looked up by the batch's BUCKETED extents, so a plan
    serves a pose neighborhood; only the per-pose ladders and pose
    packs are rebuilt."""
    src = (lay["w"], lay["h"], out_w, out_h)
    try:
        ext = _sweep_target.target_extents(
            *src, lay["focal_host"], f2_host, rot_list, pos_list,
            lay["izmin_host"], lay["izmax_host"],
        )
        bext = _sweep_target.bucket_extents(ext)
        nkey = src + (lay["focal_host"], f2_host, lay["izmin_host"],
                      lay["izmax_host"], bext.key())
        tplan = _TARGET_NEIGHBORHOOD_CACHE.get(nkey)
        if tplan is None:
            tplan = _sweep_target.plan_from_extents(*src, bext)[0]
            _lru_put(_TARGET_NEIGHBORHOOD_CACHE,
                     _TARGET_NEIGHBORHOOD_CACHE_MAX, nkey, tplan)
        else:
            _TARGET_NEIGHBORHOOD_CACHE.move_to_end(nkey)
        grids, k_t = _sweep_target.target_plane_grids(
            rot_list, pos_list, lay["focal_host"], f2_host, out_w, out_h,
            lay["w"], lay["h"], lay["izmin_host"], lay["izmax_host"],
            step_px=cfg.target_step_px, num_planes=explicit_planes,
        )
        poses = np.stack([
            _sweep_target.target_pose_scalars(
                r, c, lay["focal_host"], f2_host, out_w, out_h,
                lay["w"], lay["h"],
            )
            for r, c in zip(rot_list, pos_list)
        ])
    except ValueError:
        return None
    return (
        "target",
        (tplan, k_t),
        {
            "pose_sc": torch.as_tensor(poses, device=device),
            "grids": torch.as_tensor(grids, device=device),
        },
    )


def _plan_march_tier(lay, f2_host, out_w, out_w_true, out_h, pos_b,
                     rot_list, pos_list, rotated, cfg, explicit_planes,
                     device, dx_user=0.0, sk1=None, sk2=None):
    """The non-lateral tier cascade of lif_tpu (one definition, as its
    _plan_march_tier): 'scaled' (the aligned xyz/zoom march) for
    unrotated poses; else 'target' (the single-phase target-ray march of
    the yaw family) with 'rotated' (the two-phase march) as the fallback.
    Returns (mode, setup, per-pose device extras). Raises ValueError when
    no tier covers the pose batch (lif_tpu then falls back to the sweep).

    `out_w` is the (possibly width-padded) band width the scaled tier
    renders, with the pad's constant shift in `dx_user`; `out_w_true` the
    true output width the target and rotated tiers plan at.

    Frustum skew (sk1 source / sk2 camera, tangent units): unrotated poses
    fold it as the constant pixel shift -f1*(sk1 - sk2) into the scaled
    tier's dx/dy_user; rotated poses carry S(sk1)/S(sk2) into the
    two-phase tier's FSKR sandwiches. As in lif_tpu, skewed frustums (and
    padded widths) skip the target tier.

    The target plan (ladders, pose packs and their uploads) is memoized
    on the exact pose batch, so replayed trajectories pay it once."""
    sk1 = np.zeros(2) if sk1 is None else np.asarray(sk1, np.float64)
    sk2 = np.zeros(2) if sk2 is None else np.asarray(sk2, np.float64)
    d = -lay["focal_host"] * (sk1 - sk2)
    skewed = bool(np.abs(d).sum() > 1e-12)
    if not rotated:
        fr = lay["focal_host"] / f2_host
        plan = _sweep_scaled.scaled_plan(
            lay["w"], lay["h"], out_w, out_h, lay["focal_host"], fr,
            float(np.abs(pos_b[:, 0]).max()), float(np.abs(pos_b[:, 1]).max()),
            float(min(pos_b[:, 2].min(), 0.0)),
            float(max(pos_b[:, 2].max(), 0.0)),
            lay["izmin_host"], lay["izmax_host"],
            dx_user=dx_user + float(d[0]), dy_user=float(d[1]),
        )
        grids, k_l = _sweep_scaled.parallax_step_grids_batch(
            lay["focal_host"], pos_b, fr, out_w, out_h, lay["izmin_host"],
            lay["izmax_host"], step_px=cfg.rotated_step_px,
            num_planes=explicit_planes,
        )
        return (
            "scaled",
            (plan, k_l, fr, dx_user + float(d[0]), float(d[1])),
            {"grids": torch.as_tensor(grids, device=device)},
        )
    if dx_user == 0.0 and not skewed:
        key = (
            lay["w"], lay["h"], out_w_true, out_h, lay["focal_host"],
            f2_host, lay["izmin_host"], lay["izmax_host"],
            cfg.target_step_px, explicit_planes,
            np.asarray(rot_list, np.float64).tobytes(),
            np.asarray(pos_list, np.float64).tobytes(), str(device),
        )
        entry = _TARGET_PLAN_CACHE.get(key)
        if entry is None:
            entry = _plan_target_entry(
                lay, f2_host, out_w_true, out_h, rot_list, pos_list, cfg,
                explicit_planes, device,
            ) or "ineligible"
            _lru_put(_TARGET_PLAN_CACHE, _TARGET_PLAN_CACHE_MAX, key, entry)
        else:
            _TARGET_PLAN_CACHE.move_to_end(key)
        if entry != "ineligible":
            return entry
    sk1_t = (float(sk1[0]), float(sk1[1]))
    sk2_t = (float(sk2[0]), float(sk2[1]))
    plan, wi, hi, aligned, grids, k_l, skip = _rotated_march.plan_rotated(
        lay["w"], lay["h"], out_w_true, out_h, lay["focal_host"], f2_host,
        rot_list, pos_list, lay["izmin_host"], lay["izmax_host"],
        step_px=cfg.rotated_step_px, num_planes=explicit_planes,
        sk1=sk1_t, sk2=sk2_t,
    )
    grids = np.zeros((len(pos_list), 1), np.float32) if skip else grids
    return (
        "rotated",
        (plan, wi, hi, max(k_l, 1), skip, sk1_t, sk2_t),
        {
            "aligned": torch.as_tensor(aligned, dtype=torch.float32,
                                       device=device),
            "grids": torch.as_tensor(grids, device=device),
        },
    )


def _conj_swap_xy(rot) -> np.ndarray:
    """S @ R @ S for the x<->y swap S, by index permutation (exact,
    dtype-preserving)."""
    r = np.asarray(rot)
    return r[list(_SWAP_XY)][:, list(_SWAP_XY)].copy()


def _transposed_target_ok(tex_layers, f2_host, cam0, rot_list, pos_list):
    """True when every layer's TRANSPOSED pose batch fits the target tier:
    pitch-family rotations (source x depends on the target row, failing
    the yaw gate) become yaw-family under an x<->y transpose of source and
    target (the elevation half of the demo's spherical orbit, reference
    index.html:1271-1313).

    The transposed output width is the target HEIGHT padded
    symmetrically to lif_tpu's 128-column grid; the symmetric pad keeps
    the principal point centered, so slicing it off is frustum-exact. Odd
    pads and skewed cameras are ineligible."""
    h_pad = -(-cam0.height // 128) * 128 - cam0.height
    if h_pad % 2 or float(np.abs(cam0.skew).sum()) > 1e-12:
        return False
    rot_t = [_conj_swap_xy(r) for r in rot_list]
    pos_t = [np.asarray(p, np.float64)[list(_SWAP_XY)] for p in pos_list]
    for lay in tex_layers:
        dims = (lay["h"], lay["w"], cam0.height + h_pad, cam0.width)
        try:
            ext = _sweep_target.target_extents(
                *dims, lay["focal_host"], f2_host, rot_t, pos_t,
                lay["izmin_host"], lay["izmax_host"],
            )
        except ValueError:
            return False
        bext = _sweep_target.bucket_extents(ext)
        key = dims + (lay["focal_host"], f2_host, lay["izmin_host"],
                      lay["izmax_host"], bext.key())
        ok = _TARGET_OK_CACHE.get(key)
        if ok is None:
            try:
                _sweep_target.plan_from_extents(*dims, bext)
                ok = True
            except ValueError:
                ok = False
            _lru_put(_TARGET_OK_CACHE, _TARGET_OK_CACHE_MAX, key, ok)
        else:
            _TARGET_OK_CACHE.move_to_end(key)
        if not ok:
            return False
    return True


def _transposed_projector(projector: Projector) -> Projector:
    """Axis-swapped copy (x<->y) of a projector for the pitch route, its
    textures transposed on the device once and cached. The key covers
    the textures and every small field the copy bakes in (a projector
    moved with dataclasses.replace must miss)."""
    tkey, refs = _texture_key(projector)
    key = (
        tkey,
        np.asarray(projector.position).tobytes(),
        np.asarray(projector.rotation).tobytes(),
        np.asarray(projector.skew).tobytes(),
        np.asarray(projector.focal).tobytes(),
        np.asarray(projector.invz_min).tobytes(),
        np.asarray(projector.invz_max).tobytes(),
        float(projector.baseline),
    )
    hit = _TRANSPOSED_CACHE.get(key)
    if hit is not None and all(a is b for a, b in zip(hit[0], refs)):
        _TRANSPOSED_CACHE.move_to_end(key)
        return hit[1]
    t = dataclasses.replace(
        projector,
        rgb=projector.rgb.transpose(1, 2).contiguous(),
        disp=projector.disp.transpose(1, 2).contiguous(),
        mask=projector.mask.transpose(1, 2).contiguous(),
        layer_res=projector.layer_res[:, ::-1].copy(),
        skew=projector.skew[::-1].copy(),
        position=projector.position[list(_SWAP_XY)],
        rotation=_conj_swap_xy(projector.rotation),
        width=projector.height,
        height=projector.width,
    )
    _lru_put(_TRANSPOSED_CACHE, _TRANSPOSED_CACHE_MAX, key, (refs, t))
    return t


def _layer_tier_batch(
    lay,
    mode,
    setup,
    plan,
    k_l,
    crop_y,
    c1_b,
    rot_b,
    f2,
    out_w,
    out_h,
    *,
    refine,
    rot_refine,
    t_refine,
    feathering,
    mask_mode,
    base_offset=(0.0, 0.0),
):
    """ONE LDI layer's pose-batched render through its routed tier — the
    tier switch. c1_b (B, 3) and rot_b (B, 3, 3) are the host pose batch.
    'march': the lateral snap translation; 'scaled': the aligned march
    with its setup (plan, K, fr, dx, dy) and per-pose ladders in `lay`;
    'target': the target-ray march with its setup (plan, K) and the
    per-pose pose packs and ladders in `lay`; 'rotated': the two-phase
    march with its setup (plan, wi, hi, K, skip_phase_a, sk1, sk2) and the
    aligned positions and ladders in `lay`, rendered at the true width
    out_w. Returns the (B, H, W, 4) premultiplied RGBA over a zero
    background."""
    zero_bg = np.zeros(4, np.float32)
    if mode == "scaled":
        splan, k_s, fr, dxu, dyu = setup
        return _sweep_scaled.render_scaled_fetch_batch(
            lay["rgb"], lay["disp"], lay["mask"], lay["izmin_host"],
            lay["izmax_host"], c1_b, lay["focal_host"], fr, lay["grids"],
            zero_bg, splan, k_s, feathering=feathering, mask_mode=mask_mode,
            to_srgb=False, refine=rot_refine, dx_user=dxu, dy_user=dyu,
            skip_tables=lay.get("skip_scaled"),
        )
    if mode == "rotated":
        rplan, wi, hi, k_r, skip_a, sk1_t, sk2_t = setup
        return _rotated_march.render_rotated_march_batch(
            lay["rgb"], lay["disp"], lay["mask"], lay["izmin_host"],
            lay["izmax_host"], lay["focal_host"], c1_b, rot_b,
            lay["aligned"], f2, lay["grids"], zero_bg, rplan, k_r, out_w,
            out_h, wi, hi, feathering=feathering, mask_mode=mask_mode,
            to_srgb=False, refine=rot_refine, skip_phase_a=skip_a, sk1=sk1_t,
            sk2=sk2_t, skip_tables=lay.get("skip_scaled"),
        )
    if mode == "target":
        tplan, k_t = setup
        return _sweep_target.render_target_fetch_batch(
            lay["rgb"], lay["disp"], lay["mask"], lay["izmin_host"],
            lay["izmax_host"], lay["pose_sc"], lay["grids"], zero_bg, tplan,
            k_t, feathering=feathering, mask_mode=mask_mode, to_srgb=False,
            refine=t_refine, skip_tables=lay.get("skip_target"),
        )
    if mode != "march":
        raise NotImplementedError(f"the '{mode}' tier is not ported yet")
    rgb_l, disp_l, mask_l = _march_sources(lay, plan, crop_y)
    return _sweep_march.render_translation_batch(
        rgb_l, disp_l, mask_l, lay["izmin_host"], lay["izmax_host"],
        c1_b, lay["focal_host"], lay["plane_invz"], zero_bg,
        plan=plan, num_planes=k_l, refine=refine, feathering=feathering,
        mask_mode=mask_mode, to_srgb=False, offset=base_offset,
        crop_y=crop_y, prepared=lay.get("march_prep"),
        skip_rows=lay.get("march_rows"),
    )


def render_fast_batch(
    projector: Projector,
    cameras: Sequence[Camera],
    background=None,
    feathering: float | None = None,
    to_srgb: bool | None = None,
    num_planes: int | None = None,
    method: str = "auto",
    mask_mode: str | None = None,
    refine: int | None = None,
    config: RenderConfig | None = None,
    return_tiers: bool = False,
    _transpose: bool = True,
):
    """Render MANY novel views; returns (B, H, W, 4) on the projector's
    device (GL-oriented, row 0 = bottom).

    The port of lif_tpu's production entry point, with lif_tpu's per-layer
    tier routing over the four tiers the port has:
      * 'march': LATERAL batches (no relative rotation, translation along
        x only) on march-eligible layers (matched focal, even outpaint
        margins, plane_mode='snap', no frustum skew);
      * 'scaled': every other unrotated batch (y/z translation, dolly,
        zoom) and lateral layers that are not march-eligible;
      * 'target': rotated YAW-family batches (each layer plans with its
        own source dims); PITCH-family batches, which fail the target
        planner upright, render transposed: source and cameras x<->y
        swapped, the height padded to a 128-multiple, the pad sliced off
        and the axes swapped back on the device;
      * 'rotated': the two-phase fallback for rotated batches outside the
        target tier (yaw + pitch together, roll, skewed frustums).
    Non-8-divisible widths render a padded band on 'march'/'scaled' and
    slice the true width; the pad is dropped when a layer takes another
    tier. On CUDA each layer launches its kernel once per pose chunk; the
    layers are over-composited front to back. A batch no march tier
    covers (lif_tpu's 'sweep' fallback), a skewed lateral batch and the
    sweep method raise NotImplementedError naming what they need.

    return_tiers=True returns (images, tiers) with the per-layer tier.
    Batches larger than config.pose_chunk render in balanced chunks (a
    bound on the per-chunk intermediates, nothing more). All cameras must
    share width/height/focal/skew; poses may vary. plan_tiers gives the
    planning alone.
    """
    cfg = config or DEFAULT_CONFIG
    background = cfg.background if background is None else background
    feathering = cfg.feathering if feathering is None else feathering
    to_srgb = cfg.to_srgb if to_srgb is None else to_srgb
    refine = cfg.march_refine if refine is None else refine
    if method not in ("auto", "march"):
        raise NotImplementedError(
            f"method={method!r}: the plane-sweep tier is not ported yet"
        )
    tp = plan_tiers(projector, cameras, cfg, num_planes)
    cam0 = cameras[0]
    pos_b, rot_b, planned = tp.pos_b, tp.rot_b, tp.planned
    out_w_eff, dx_pad = tp.out_w_eff, tp.dx_pad
    if mask_mode is None:
        mask_mode = "multiply" if projector.num_layers > 1 else "none"
    modes = [p[0] for p in planned]
    if (
        _transpose
        and tp.rotated
        and any(m in ("rotated", "sweep") for m in modes)
        and _transposed_target_ok(tp.tex_layers, tp.f2_host, cam0,
                                  tp.rot_list, tp.pos_list)
    ):
        return _render_transposed(
            projector, cameras, return_tiers, background=background,
            feathering=feathering, to_srgb=to_srgb, num_planes=num_planes,
            method=method, mask_mode=mask_mode, refine=refine, config=config,
        )
    if "sweep" in modes and (method == "march" or tp.skewed):
        raise ValueError(
            "method='march' or a skewed frustum needs poses the march tiers "
            "cover (lateral, aligned xyz/zoom, or bounded rotation with "
            "matched-focal layers)"
        )
    for _, setup, _ in planned:
        if isinstance(setup, _TierNotPorted):
            raise setup

    max_cx = float(np.abs(pos_b[:, 0]).max())
    layers, setups, plans, crops, nums = [], [], [], [], []
    for lay, (mode, setup, extra) in zip(tp.tex_layers, planned):
        plan, crop_y, k_l = None, 0, None
        if mode == "march":
            plan = _march_plan(dict(lay, h=cam0.height), max_cx, out_w_eff,
                               cam0.height, phase_abs=dx_pad)
            crop_y = (lay["h"] - cam0.height) // 2
            tab, k_l = _snap_tables(lay, pos_b[:, 0], num_planes, 0.0,
                                    cfg.march_stride, projector.device)
            extra = {"plane_invz": tab}
        layers.append(dict(lay, **extra))
        setups.append(setup)
        plans.append(plan)
        crops.append(crop_y)
        nums.append(k_l)
    out = _fast_batch_core(
        layers, modes, setups, pos_b, rot_b, background, plans=plans,
        nums=nums, crops=crops, refine=refine, rot_refine=cfg.rotated_refine,
        t_refine=cfg.target_refine, feathering=feathering,
        mask_mode=mask_mode, to_srgb=to_srgb, pad_dx=dx_pad, f2=tp.f2_host,
        out_h=cam0.height, out_w_true=cam0.width, pose_chunk=cfg.pose_chunk,
    )
    return (out, tuple(modes)) if return_tiers else out


class TierPlan(NamedTuple):
    """How render_fast_batch plans a pose batch, before the pitch route's
    transpose: the per-layer (mode, setup, per-pose device extras) of the
    tier cascade, with the inputs it was planned from."""

    tex_layers: list  # _prepared_textures, one dict per LDI layer
    planned: list  # per layer (mode, setup, extras); 'sweep': the error
    pos_b: np.ndarray  # (B, 3) relative projector positions
    rot_b: np.ndarray  # (B, 3, 3) relative rotations
    pos_list: tuple
    rot_list: tuple
    rotated: bool
    skewed: bool
    f2_host: float  # camera focal, px
    out_w_eff: int  # band width of 'march'/'scaled' (the width pad)
    dx_pad: float  # the pad's constant x-offset


def plan_tiers(projector: Projector, cameras: Sequence[Camera],
               config: RenderConfig | None = None,
               num_planes: int | None = None) -> TierPlan:
    """Plan a pose batch as render_fast_batch does (relative poses, the
    per-layer tier cascade, the width pad) without rendering it. The
    'scaled' setup is (plan, K, fr, dx_user, dy_user) with the ladders in
    extras['grids']; the 'rotated' setup is (plan, wi, hi, K,
    skip_phase_a, sk1, sk2) with extras['aligned'] and extras['grids'];
    the 'target' setup is (plan, K); 'march' plans later, per call. Raises
    what render_fast_batch raises for cameras it cannot batch."""
    cfg = config or DEFAULT_CONFIG
    if len(cameras) == 0:
        raise ValueError("render_fast_batch needs at least one camera")
    cam0 = cameras[0]
    for cam in cameras[1:]:
        if (
            cam.width != cam0.width
            or cam.height != cam0.height
            or abs(float(cam.focal_px) - float(cam0.focal_px)) > 1e-6
            or not np.allclose(cam.skew, cam0.skew)
        ):
            raise ValueError(
                "render_fast_batch cameras must share intrinsics "
                "(width/height/focal/skew)"
            )

    pos_list, rot_list = zip(*(
        relative_view_pose(
            projector.position, projector.rotation, cam.position,
            cam.rotation,
        )
        for cam in cameras
    ))
    pos_b = np.stack(pos_list)  # (B, 3)
    rot_b = np.stack(rot_list)  # (B, 3, 3)
    rotated = not np.allclose(rot_b, np.eye(3), atol=1e-5)
    lateral = (
        not rotated
        and np.abs(pos_b[:, 1]).max() < 1e-9
        and np.abs(pos_b[:, 2]).max() < 1e-9
    )
    sk1 = np.asarray(projector.skew, np.float64)
    sk2 = np.asarray(cam0.skew, np.float64)
    skewed = bool(np.abs(sk1 - sk2).sum() > 1e-12)
    tex_layers = _prepared_textures(projector)
    f2_host = float(cam0.focal_px)
    if lateral and cfg.plane_mode != "snap":
        raise NotImplementedError(
            f"plane_mode={cfg.plane_mode!r}: only the snap march grid is "
            "ported"
        )
    if lateral and skewed:
        raise NotImplementedError(
            "skewed frustums need the skewed lateral fold, which is not "
            "ported yet"
        )

    def layer_mode(lay, out_w_eff, dx_pad):
        """Per-layer tier: 'march' (lateral snap), else the non-lateral
        cascade; a batch no march tier covers is lif_tpu's 'sweep'."""
        if lateral and _march_eligible(lay, f2_host, out_w_eff, cam0.height,
                                       out_w_true=cam0.width):
            return "march", None, {}
        try:
            return _plan_march_tier(
                lay, f2_host, out_w_eff, cam0.width, cam0.height, pos_b,
                rot_list, pos_list, rotated, cfg, num_planes,
                projector.device, dx_user=dx_pad, sk1=sk1, sk2=sk2,
            )
        except ValueError as err:
            return "sweep", _TierNotPorted(
                "sweep", f"no march tier covers this pose batch ({err})"
            ), {}

    # non-8-divisible widths: the band tiers render a wpad-wider band with
    # a constant wpad/2 x-offset, then slice the true width. Any other
    # tier renders around the true image center, so the pad is dropped
    # and only the band-tier layers re-plan.
    wpad = _width_pad(cam0.width)
    out_w_eff, dx_pad = cam0.width + wpad, wpad / 2.0
    planned = [layer_mode(lay, out_w_eff, dx_pad) for lay in tex_layers]
    if wpad and not all(p[0] in ("march", "scaled") for p in planned):
        out_w_eff, dx_pad = cam0.width, 0.0
        planned = [
            layer_mode(lay, out_w_eff, dx_pad)
            if p[0] in ("march", "scaled") else p
            for lay, p in zip(tex_layers, planned)
        ]
    return TierPlan(tex_layers, planned, pos_b, rot_b, pos_list, rot_list,
                    rotated, skewed, f2_host, out_w_eff, dx_pad)


def _render_transposed(projector, cameras, return_tiers, **kwargs):
    """The pitch route: render the x<->y transposed problem (target
    height padded symmetrically to a 128-multiple), slice the pad off and
    swap the axes back on the device. The recursive call cannot transpose
    again: the doubly transposed batch is the one whose plan just
    failed."""
    cam0 = cameras[0]
    h_pad = -(-cam0.height // 128) * 128 - cam0.height
    half = h_pad // 2
    cams_t = [
        Camera.create(
            cam0.height + h_pad, cam0.width, focal_px=float(cam0.focal_px),
            position=np.asarray(cam.position, np.float64)[list(_SWAP_XY)],
            rotation=_conj_swap_xy(cam.rotation),
            skew=np.asarray(cam0.skew)[::-1],
        )
        for cam in cameras
    ]
    res = render_fast_batch(
        _transposed_projector(projector), cams_t, return_tiers=return_tiers,
        _transpose=False, **kwargs,
    )
    out_t, tiers = res if return_tiers else (res, None)
    out = out_t[:, :, half : half + cam0.height, :].transpose(1, 2)
    out = out.contiguous()
    return (out, tiers) if return_tiers else out


# layer keys that carry a leading pose axis (split by the pose chunks)
_PP_KEYS = ("plane_invz", "grids", "aligned", "pose_sc")


def _fast_batch_core(
    layers, modes, setups, c1_b, rot_b, background, *, plans, nums, crops,
    refine, rot_refine, t_refine, feathering, mask_mode, to_srgb, pad_dx, f2,
    out_h, out_w_true, pose_chunk,
):
    """The body of render_fast_batch: hoists the march's source prep, then
    renders balanced pose chunks of at most `pose_chunk` poses (a bound
    on the per-chunk intermediates) and slices the width pad off."""
    layers = _attach_march_prep(layers, modes, plans, crops)
    tier_kw = dict(
        refine=refine, rot_refine=rot_refine, t_refine=t_refine,
        feathering=feathering, mask_mode=mask_mode,
        base_offset=(pad_dx, 0.0),
    )
    batch = len(c1_b)
    size = batch
    if pose_chunk and batch > pose_chunk:
        size = _balanced_chunk(batch, pose_chunk)
    outs = []
    for s in range(0, batch, size):
        # front-to-back LDI over-compositing of the chunk's layers
        result_rgb = result_a = None
        for lay, mode, setup, plan, k_l, crop_y in zip(
            layers, modes, setups, plans, nums, crops
        ):
            lay = dict(lay, **{k: lay[k][s : s + size]
                               for k in _PP_KEYS if k in lay})
            layer = _layer_tier_batch(
                lay, mode, setup, plan, k_l, crop_y, c1_b[s : s + size],
                rot_b[s : s + size], f2, out_w_true, out_h, **tier_kw,
            )  # (B, H, W, 4), premultiplied
            la = layer[..., 3]
            if result_rgb is None:
                result_rgb, result_a = layer[..., :3], la
            else:
                result_rgb = (result_rgb
                              + (1.0 - result_a[..., None]) * layer[..., :3])
                result_a = result_a + (1.0 - result_a) * la
        outs.append(_composite.finish_over_background(
            result_rgb, result_a, background, to_srgb
        ))
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out[:, :, :out_w_true, :] if out.shape[2] != out_w_true else out


def render_mono_view(
    projector: Projector,
    camera: Camera,
    background=None,
    feathering: float | None = None,
    to_srgb: bool | None = None,
    num_steps: int | None = None,
    mask_mode: str | None = None,
    config: RenderConfig | None = None,
):
    """Render one projector into the camera with the exact ray march (the
    reference's raytracing mode). Returns (H, W, 4) GL-oriented, on the
    projector's device.

    mask_mode defaults to the reference behaviour: LDI projectors multiply
    the bilinear mask into alpha; single-layer projectors use the taper
    only (rayCastMonoLDI.glsl:277-279). Unset keyword knobs resolve from
    `config` (DEFAULT_CONFIG when None)."""
    cfg = config or DEFAULT_CONFIG
    background = cfg.background if background is None else background
    feathering = cfg.feathering if feathering is None else feathering
    to_srgb = cfg.to_srgb if to_srgb is None else to_srgb
    num_steps = cfg.num_steps if num_steps is None else num_steps
    pos, rot = relative_view_pose(
        projector.position, projector.rotation, camera.position,
        camera.rotation,
    )
    if mask_mode is None:
        mask_mode = "multiply" if projector.num_layers > 1 else "none"
    # baseline-normalized ranges, divided in float32 as lif_tpu does
    baseline = np.float32(projector.baseline)
    return _raycast.render_mono(
        projector.rgb,
        projector.disp,
        projector.mask,
        projector.layer_res,
        np.asarray(projector.invz_min, np.float32) / baseline,
        np.asarray(projector.invz_max, np.float32) / baseline,
        projector.focal,
        projector.skew,
        np.asarray(pos, np.float32),
        np.asarray(rot, np.float32),
        float(camera.focal_px),
        camera.skew,
        background,
        out_w=camera.width,
        out_h=camera.height,
        num_layers=projector.num_layers,
        feathering=feathering,
        num_steps=num_steps,
        mask_mode=mask_mode,
        to_srgb=to_srgb,
    )


def render(projectors, camera: Camera, mode: str = "raycast", **kwargs):
    """Render-mode dispatch (the HoloRenderer.onBeforeRender analog,
    reference HoloRenderer.ts:139-204), on the first projector:
      * 'raycast': the per-pixel inverse-depth march;
      * 'mesh': connected-triangle rasterization of the (W+1)x(H+1)
        corner grid (ops.mesh; the reference's default mesh mode,
        holoVertex.glsl meshMode=1 + HoloRenderer.ts:809-858);
      * 'billboard': the per-pixel square-footprint splat (ops.splat; the
        reference's billboard mode, holoVertex.glsl meshMode=0).
    The stereo and fast modes are not ported yet."""
    plist = list(projectors) if isinstance(projectors, (list, tuple)) else [projectors]
    if mode == "raycast":
        return render_mono_view(plist[0], camera, **kwargs)
    if mode == "mesh":
        return _mesh.render_mesh_connected_view(plist[0], camera, **kwargs)
    if mode == "billboard":
        return _splat.render_mesh_view(plist[0], camera, **kwargs)
    if mode in ("fast", "stereo", "stereo_fast"):
        raise NotImplementedError(f"render mode {mode!r} is not ported yet")
    raise ValueError(f"unknown render mode: {mode}")


class BillboardPlan(NamedTuple):
    """How render_billboard_fast_batch plans a lateral pose batch."""

    layer: dict  # _prepared_textures' layer 0
    c1x: np.ndarray  # (B,) relative x positions of the projector
    plan: _sweep_march.TranslationPlan  # the ladders' windows
    ixs: np.ndarray  # (B, K) int32 window starts
    mms: np.ndarray  # (B, K) float32 integer shifts
    num_planes: int  # K
    cx0: float  # principal point x, px
    cy0: float  # principal point y (GL, bottom origin), px


def plan_billboard(projector: Projector, cameras: Sequence[Camera],
                   point_size: float = 1.0) -> BillboardPlan:
    """Plan a billboard pose batch as render_billboard_fast_batch does,
    without rendering it; raises ValueError for what it cannot take."""
    cam0 = cameras[0]
    lay = _prepared_textures(projector)[0]
    intr = projector.intrinsics
    cy_gl = projector.height - float(intr["cy"])
    if (
        lay["w"] != cam0.width or lay["h"] != cam0.height
        or abs(lay["focal_host"] - float(cam0.focal_px)) > 1e-6
        or abs(float(intr["cx"]) - lay["w"] / 2.0) > 1e-6
        or abs(cy_gl - lay["h"] / 2.0) > 1e-6
        or lay["w"] % 8 != 0
    ):
        raise ValueError(
            "render_billboard_fast_batch needs matched focal/dims, "
            "centered principal point, and an 8-divisible width; use "
            "render(mode='billboard') per frame otherwise"
        )
    pos_list = []
    for cam in cameras:
        pos_np, rot_np = relative_view_pose(
            projector.position, projector.rotation, cam.position,
            cam.rotation,
        )
        if not np.allclose(rot_np, np.eye(3), atol=1e-5) or (
            abs(pos_np[1]) > 1e-9 or abs(pos_np[2]) > 1e-9
        ):
            raise ValueError(
                "render_billboard_fast_batch needs lateral poses; use "
                "render(mode='billboard') per frame otherwise"
            )
        pos_list.append(pos_np)
    pos_b = np.stack(pos_list)
    f1 = lay["focal_host"]
    su_half = _splat_march.su_half_bound(point_size, lay["w"], lay["h"], f1)
    if su_half >= 1.0:
        raise ValueError(
            f"render_billboard_fast_batch needs su < 2, but point_size "
            f"{point_size} reaches su/2 = {su_half:.4f} at the image corner; "
            "use render(mode='billboard') per frame"
        )
    max_shift = abs(f1) * float(np.abs(pos_b[:, 0]).max()) * max(
        abs(lay["izmin_host"]), abs(lay["izmax_host"])
    ) + 4.0
    plan = _sweep_march.translation_plan(
        lay["w"], lay["h"], lay["w"], lay["h"], max_shift, 0.0
    )
    ixs, mms, k = _splat_march.billboard_shift_tables(
        f1, pos_b[:, 0].tolist(), lay["izmin_host"], lay["izmax_host"], plan,
    )
    return BillboardPlan(lay, pos_b[:, 0], plan, ixs, mms, k,
                         float(intr["cx"]), cy_gl)


def render_billboard_fast_batch(
    projector: Projector,
    cameras: Sequence[Camera],
    background=(0.0, 0.0, 0.0, 0.0),
    point_size: float = 1.0,
    to_srgb: bool = True,
    show_depth: bool = False,
):
    """Billboard (splat) mode over a whole lateral pose batch: the row
    z-buffer scatter of ops.splat_march, exact against
    render(mode='billboard') on these poses. On a CUDA
    projector it is ONE kernel launch for the batch; on a CPU projector
    its plain version billboard_scatter_plain (not lif_tpu's per-frame XLA
    scatter: the port's CPU branch computes what the kernel computes).
    Returns (B, H, W, 4) on the projector's device.

    Eligibility, lif_tpu's gates and messages: layer-0 dims equal to the
    camera's, matched focal, centered principal point, an 8-divisible
    width, lateral poses (no relative rotation, translation along x only).
    Other poses render one frame at a time through
    render(mode='billboard'). Beyond lif_tpu, a footprint that can reach
    su >= 2 (0.5 * point_size * the widest corner's su >= 1), where the
    dual is no longer exact, raises ValueError instead of rendering wrong
    images. plan_billboard gives the planning alone. reference:
    holoVertex.glsl:130-149, 243-273 (billboard quads + z-buffer)."""
    bp = plan_billboard(projector, cameras, point_size)
    lay = bp.layer
    return _splat_march.render_billboard_batch(
        lay["rgb"], lay["disp"], lay["mask"], lay["izmin_host"],
        lay["izmax_host"], bp.c1x, lay["focal_host"], bp.ixs, bp.mms,
        background, bp.plan, bp.num_planes, cx0=bp.cx0, cy0=bp.cy0,
        point_size=point_size, to_srgb=to_srgb, show_depth=show_depth,
    )
