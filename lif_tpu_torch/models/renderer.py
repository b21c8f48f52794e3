"""Renderer: render-mode dispatch from (projector, camera) to images.

The counterpart of lif_tpu.models.renderer for the slice the port has so
far: the exact ray march (render_mono_view, render(mode='raycast')), the
single-view fast path (render_fast_view, render(mode='fast')) with its
depth solve render_depth_fast, and the production fast path
render_fast_batch on five tiers —
  * 'march': LATERAL pose batches, the first-crossing plane march on
    config.plane_mode's grid (integer-parallax 'snap', or 'uniform' /
    'hybrid' of config.march_planes planes; on CUDA through
    csrc/sweep_march.cu);
  * 'scaled': other UNROTATED batches (y/z translation, dolly, zoom) and
    lateral layers the march cannot take, the scaled first-crossing march
    plus one packed color fetch (on CUDA through csrc/sweep_scaled.cu);
  * 'target': rotated YAW-family pose batches (the orbit), the
    single-phase target-ray march (on CUDA through csrc/sweep_target.cu),
    and PITCH-family batches through an x<->y transpose onto it;
  * 'rotated': the two-phase fallback for other rotated batches, phase A
    on the scaled march (csrc/sweep_scaled.cu), phase B plain torch;
  * 'sweep': the plane sweep (ops/sweep_fast.py, plain torch: matrix
    products and elementwise passes, as lif_tpu's is XLA outside any
    Pallas kernel) for the layers and poses no march tier covers, with
    lif_tpu's TierFallbackWarning where 'auto' demotes a layer to it, and
    for method='sweep'.
The mesh modes: render(mode='billboard') is the billboard scatter
(ops/splat.py) and render(mode='mesh') the connected-mesh rasterizer
(ops/mesh.py), both plain torch on any device; render_billboard_fast_batch
renders a lateral pose batch in billboard mode through the row z-buffer
scatter (on CUDA through csrc/splat_march.cu, one launch per batch; on
the CPU its plain version billboard_scatter_plain).
The stereo modes: render_stereo_view (render(mode='stereo')) blends two
projectors' exact marches (ops/stereo.py); render_stereo_fast_batch and
render_stereo_fast (render(mode='stereo_fast')) route each eye's layers
through the same tiers with their raw outputs, add the stretch-mark
confidence and fill and blend the eyes as the exact kernel does: a layer
both eyes march laterally in one stereo epilogue kernel a pose chunk
(ops/cuda/stereo_epilogue.py; on the CPU its plain version, the PyTorch
chain), any other layer through the chain (raw=True of _layer_tier_batch:
colour, alpha, hit, invz*; _stretch_conf; occlusion_blend); LDI eyes
march the eroded stereo mask (_eroded_mask).
Multi-projector fusion: render_fused_fast_batch and render_fused_fast
march every layer of every projector on the lateral tier with its raw
outputs, composite each projector's LDI and merge the projectors at the
frontmost surface (composite.fusion_weights, config.fuse_tol): on the card
in one fused epilogue kernel a pose chunk (ops/cuda/fused_epilogue.py),
on the CPU in its plain version, the PyTorch chain; the exact fused
oracle is parallel.sharding.render_fused_projectors.

Host-side planning (relative poses, plane grids, pad plans, the tiers'
extents and pose packs) runs in numpy; the textures and every per-pixel
operation stay on the projector's device. Every fast entry point reads
a camera batch's relative poses, and decides whether it is lateral, in
_read_poses, and plans a 'march' layer in _plan_march_layer.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections import OrderedDict
from typing import Literal, NamedTuple, Sequence

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
from ..ops import stereo as _stereo
from ..ops import sweep_fast as _sweep_fast
from ..ops import sweep_march as _sweep_march
from ..ops import sweep_scaled as _sweep_scaled
from ..ops import sweep_target as _sweep_target
from ..ops.cuda import fused_epilogue as _fused_epilogue
from ..ops.cuda import stereo_epilogue as _stereo_epilogue
from ..ops.cuda import sweep_march as _cuda_march
from ..ops.cuda.sweep_march import prepare_translation_src
from ..ops.cuda.sweep_target import skip_table_buffer
from ..ops.sampling import pack_rgbm
from ..utils import profiling
from .projector import Projector

__all__ = ["BillboardPlan", "RenderMode", "TierFallbackWarning", "TierPlan",
           "plan_billboard", "plan_tiers", "render",
           "render_billboard_fast_batch", "render_depth_fast",
           "render_fast_batch", "render_fast_view", "render_fused_fast",
           "render_fused_fast_batch", "render_mono_view",
           "render_stereo_fast", "render_stereo_fast_batch",
           "render_stereo_view"]

RenderMode = Literal[
    "raycast", "stereo", "stereo_fast", "mesh", "billboard", "fast"
]

# Two caches for the fast path, both LRU. The TEXTURE cache holds the
# pose-independent per-layer views, host scalars and the kernels' skip
# tables once per projector; it keys on the identity of the texture
# tensors plus their in-place version counters and on the host fields the
# entry bakes in, and stores strong references so the ids stay valid. The
# TABLE cache holds the per-pose snap-plane grids on the device: building
# them is host numpy per pose, which a replayed trajectory must not pay
# every frame. The PLANE-TABLE cache holds the sweep's per-(disparity,
# ranges, K, mode) tables (_sweep_tables): a hybrid table reads quantiles
# of the whole disparity map on the host, which must not happen per frame.
_TEX_CACHE: OrderedDict = OrderedDict()
_TEX_CACHE_MAX = 16
_TABLE_CACHE: OrderedDict = OrderedDict()
_TABLE_CACHE_MAX = 64
_PLANE_TABLE_CACHE: OrderedDict = OrderedDict()
_PLANE_TABLE_CACHE_MAX = 64

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
# per CUDA layer: the lateral kernel's march packs (_march_pack), keyed on
# the mask marched (the texture's or the eroded stereo mask), the skew
# fold's y shift, the crop and the plan
_MARCH_PACK_MAX = 4

# x<->y axis swap: transposing every image conjugates all camera-space
# quantities by this permutation. Applied by INDEXING, so it is exact.
_SWAP_XY = (1, 0, 2)

# _read_poses' rotation test, np.allclose(rot, I, atol=1e-5) element for
# element (|rot - I| <= atol + rtol * |I|; NaN and inf never close)
# without np.allclose's fixed cost, which a single view pays every frame
_EYE3 = np.eye(3)
_ROT_TOL = 1e-5 + 1e-5 * _EYE3


class TierFallbackWarning(UserWarning):
    """A layer left the march-tier cascade for the ~35 dB plane sweep."""


def _warn_sweep_fallback(idx, err, stacklevel=3):
    """Surface a quality demotion (lif_tpu's warning, word for word): the
    march-tier planner rejected this layer (mismatched focal,
    window/candidate budget, pose family), so it renders through the
    approximate plane sweep instead of a march-exact tier."""
    warnings.warn(
        f"layer {idx if idx is not None else '?'} fell back to the "
        f"approximate plane-sweep tier (expect ~35 dB, not march-exact): "
        f"{err}",
        TierFallbackWarning,
        stacklevel=stacklevel,
    )


# the counters of each LRU cache (_lru_get): cache.<name>.hit / .miss
_LRU_COUNTERS = {
    name: (f"cache.{name}.hit", f"cache.{name}.miss")
    for name in ("texture", "table", "plane_table", "target_plan",
                 "target_neighborhood", "target_ok", "transposed",
                 "march_pack")
}


# the tier each layer of a render_fast_batch call (the pitch route's inner
# call) and each eye-layer of a render_stereo_fast_batch call renders on
_ROUTE_COUNTERS = {mode: f"route.{mode}" for mode in
                   ("march", "scaled", "target", "rotated", "sweep")}


def _lru_get(cache: OrderedDict, key, name: str, valid=None):
    """The entry of `cache` under `key`, moved to the LRU end, or None
    where there is none or `valid(entry)` is false; counted as a hit or a
    miss of cache.<name> (utils.profiling.count)."""
    entry = cache.get(key)
    hit, miss = _LRU_COUNTERS[name]
    if entry is None or (valid is not None and not valid(entry)):
        profiling.count(miss)
        return None
    cache.move_to_end(key)
    profiling.count(hit)
    return entry


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
    it can) and the lateral kernel's (r8, r32) row tables, with an LRU of
    its march packs (_march_pack). A CPU texture takes the plain marches,
    which read none of them."""
    if disp.device.type != "cuda":
        return {}
    target = skip_table_buffer(disp)
    return dict(
        skip_target=target,
        skip_scaled=_sweep_scaled.skip_pack(disp, izmin, izmax,
                                            target=target),
        skip_rows=_sweep_march.row_skip_tables(disp, izmin, izmax)[1:],
        march_packs=OrderedDict(),
    )


def _prepared_textures(projector):
    """Pose-independent per-layer constants, cached once per projector:
    texture views on the device, baseline-normalized ranges, the host
    scalars the planners read and the kernels' skip tables (_layer_skip).
    Returns a list of per-layer dicts."""
    key, refs = _texture_key(projector)
    hit = _lru_get(_TEX_CACHE, key, "texture",
                   lambda e: all(a is b for a, b in zip(e[0], refs)))
    if hit is not None:
        return hit[1]

    with profiling.span("lif.prep"):
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
        _lru_put(_TEX_CACHE, _TEX_CACHE_MAX, key, (refs, layers))
    return layers


def _snap_tables(lay, cxs, explicit_planes, phase_px, stride, device):
    """Per-pose snap-plane grids (B, K) on `device` plus K, memoized on
    the exact pose batch (the uniform and hybrid grids are one table a
    layer, cached by _sweep_tables)."""
    cxs = np.asarray(cxs, np.float64)
    key = (
        lay["focal_host"], lay["izmin_host"], lay["izmax_host"],
        cxs.tobytes(), explicit_planes, float(phase_px), int(stride),
        str(device),
    )
    hit = _lru_get(_TABLE_CACHE, key, "table")
    if hit is not None:
        return hit
    tab, k = _sweep_march.snap_plane_tables_batch(
        lay["focal_host"], cxs, lay["izmin_host"], lay["izmax_host"],
        num_planes=explicit_planes, phase_px=phase_px, stride=stride,
    )
    entry = (torch.as_tensor(tab, device=device), k)
    profiling.host_sync("sync.upload.plane_table", entry[0].device)
    _lru_put(_TABLE_CACHE, _TABLE_CACHE_MAX, key, entry)
    return entry


def _plane_table(disp_host, izmin_f, izmax_f, num_planes, mode="uniform"):
    """Inverse-depth plane table, near -> far (strictly descending),
    lif_tpu's numpy host code verbatim, so the tables are bit-equal.

    mode='uniform': the march's own step positions,
    izmin - k * (izmin - izmax) / K, scene-independent.

    mode='hybrid': 75% disparity quantiles + 25% uniform, useful when K
    must stay small and the disparity mass is tightly clustered (the
    sweep's tables)."""
    if mode == "uniform":
        step = (izmin_f - izmax_f) / num_planes
        return (
            izmin_f - np.arange(num_planes, dtype=np.float32) * step
        ).astype(np.float32)
    if mode != "hybrid":
        raise ValueError(f"unknown plane mode: {mode}")
    kq = num_planes - num_planes // 4
    qs = np.quantile(disp_host, np.linspace(0.002, 0.998, kq)).astype(
        np.float32
    )
    vals = np.concatenate(
        [
            izmax_f + (izmin_f - izmax_f) * qs,
            izmax_f
            + (izmin_f - izmax_f)
            * np.linspace(0.001, 0.999, num_planes - kq).astype(np.float32),
        ]
    )
    vals = np.sort(vals)[::-1].copy()
    # keep planes strictly descending (dedupe flat regions)
    eps = (izmin_f - izmax_f) * 1e-6
    return vals - np.arange(num_planes, dtype=np.float32) * eps


def _disp_host(lay) -> np.ndarray:
    """A float32 host copy of one cached texture layer's disparity, made on
    first use and kept in the layer's texture-cache entry (whose key holds
    the disparity's version counter, so a write gets a new copy)."""
    if "disp_host" not in lay:
        lay["disp_host"] = lay["disp"].detach().to(
            "cpu", torch.float32).numpy()
        profiling.host_sync("sync.readback.disp", lay["disp"].device)
    return lay["disp_host"]


def _sweep_tables(projector, tex_layers, num_planes, mode="hybrid"):
    """The sweep's per-layer plane tables (K,) on the projector's device,
    cached per (disparity, ranges, layer_res, K, mode) as lif_tpu's
    _prepared_fast caches them. The key holds the disparity tensor's
    identity and in-place version counter (a fit writing into the same
    tensor must not be served stale tables) and the entry a strong
    reference to it, so its id cannot be reused while the entry stands;
    it holds layer_res because each table is built from the disparity
    sliced to it (a dataclasses.replace projector with a smaller layer
    keeps the first one's tensor)."""
    key = (
        id(projector.disp), _disp_fingerprint(projector.disp),
        np.asarray(projector.invz_min).tobytes(),
        np.asarray(projector.invz_max).tobytes(),
        np.asarray(projector.layer_res).tobytes(),
        float(projector.baseline), num_planes, mode, str(projector.device),
    )
    hit = _lru_get(_PLANE_TABLE_CACHE, key, "plane_table",
                   lambda e: e[0] is projector.disp)
    if hit is not None:
        return hit[1]
    tabs = [
        torch.as_tensor(_plane_table(
            _disp_host(lay), lay["izmin_host"], lay["izmax_host"],
            num_planes, mode=mode,
        ), device=projector.device)
        for lay in tex_layers
    ]
    profiling.host_sync("sync.upload.plane_table", projector.device,
                        len(tabs))
    _lru_put(_PLANE_TABLE_CACHE, _PLANE_TABLE_CACHE_MAX, key,
             (projector.disp, tabs))
    return tabs


_PLANE_MODES = ("snap", "uniform", "hybrid")


def _check_plane_mode(cfg):
    """config.plane_mode, one of the march's grids, or lif_tpu's
    ValueError where its _prepared_fast would build the tables."""
    if cfg.plane_mode not in _PLANE_MODES:
        raise ValueError(f"unknown plane mode: {cfg.plane_mode}")


def _march_tables(projector, idx, cfg, num_planes, cxs, phase):
    """Layer idx's per-pose march plane tables (B, K) on the projector's
    device, and K, on the grid config.plane_mode picks: 'snap', per pose
    and phase-aligned to the skew fold (_snap_tables); 'uniform' or
    'hybrid', one (K,) table of num_planes planes (config.march_planes
    when None) shared by the batch as lif_tpu shares it (_sweep_tables:
    no phase, the warps fall between texels), expanded to (B, K) so that
    pose chunks and the kernel's per-pose tables see it as a snap
    ladder."""
    tex_layers = _prepared_textures(projector)
    if cfg.plane_mode == "snap":
        return _snap_tables(tex_layers[idx], cxs, num_planes, phase,
                            cfg.march_stride, projector.device)
    k = cfg.march_planes if num_planes is None else num_planes
    tab = _sweep_tables(projector, tex_layers, k, cfg.plane_mode)[idx]
    return tab.expand(len(cxs), k), k


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


def _march_fold(lay, sk1, sk2, max_cx, out_w, out_h, dx_pad):
    """One 'march' layer's setup with lif_tpu's skew fold: frustum skew
    (sk1 source, sk2 camera) is the constant pixel shift d = -f1*(sk1 -
    sk2); its x part rides the snap phase (so the total shift stays
    integer at every plane) and, with the width pad's dx, the warp
    offset; its y part the source pre-shift (_march_sources). Returns
    (plan, crop_y, the snap phase d[0], doff = (d[0] + dx_pad, d[1]))."""
    d = -lay["focal_host"] * (np.asarray(sk1, np.float64)
                              - np.asarray(sk2, np.float64))
    plan = _march_plan(dict(lay, h=out_h), max_cx, out_w, out_h,
                       phase_abs=dx_pad - float(d[0]))
    return (plan, (lay["h"] - out_h) // 2, float(d[0]),
            (float(d[0]) + dx_pad, float(d[1])))


def _plan_march_layer(projector, idx, lay, cfg, num_planes, cxs, sk2, out_w,
                      out_h, dx_pad=0.0, view=False):
    """Plan layer idx of the projector (`lay`, its _prepared_textures
    entry) on the 'march' tier for a lateral batch at x positions `cxs`,
    as every fast entry point plans it: the skew fold against the
    camera's skew sk2 with the width pad's dx_pad (_march_fold), then the
    plane tables of config.plane_mode's grid (_march_tables). view=True
    plans render_fast_view's one pose as lif_tpu's view does: on 'snap',
    the pose's own snap_plane_table (march_stride ignored), built and
    uploaded every call: at num_planes=None a one-row
    snap_plane_tables_batch builds its ladder at the bucketed K, which
    can double the stride where an endpoint plane is filtered. Returns
    (the layer dict with its `plane_invz` and `doff`, the plan, crop_y,
    K)."""
    profiling.count("plan.march_layer")
    plan, crop_y, phase, doff = _march_fold(
        lay, projector.skew, sk2, float(np.abs(cxs).max()), out_w, out_h,
        dx_pad)
    if view and cfg.plane_mode == "snap":
        tab, k_l = _sweep_march.snap_plane_table(
            lay["focal_host"], float(cxs[0]), lay["izmin_host"],
            lay["izmax_host"], num_planes=num_planes, phase_px=phase,
        )
        tab = torch.as_tensor(tab[None], device=projector.device)
        profiling.host_sync("sync.upload.plane_table", tab.device)
    else:
        tab, k_l = _march_tables(projector, idx, cfg, num_planes, cxs, phase)
    return dict(lay, plane_invz=tab, doff=doff), plan, crop_y, k_l


def _plan_layers(projector, tex_layers, modes, cfg, num_planes, cxs, sk2,
                 out_w, out_h, dx_pad, sweep_opts, planned=None, view=False):
    """_fast_batch_core's per-layer lists (layer dicts, setups, plans,
    crops, plane counts) for the tiers `modes`: a 'march' layer through
    _plan_march_layer (view: see there), a 'sweep' layer on its cached
    'hybrid' table with the setup (K, *sweep_opts), any other tier with
    the setup and extras plan_tiers planned for it (`planned`, per layer
    (mode, setup, extras)), a 'target' or 'scaled' layer with its
    _packed_texture."""
    k_sweep = num_planes or cfg.sweep_planes
    layers, setups, plans, crops, nums = [], [], [], [], []
    for idx, (lay, mode) in enumerate(zip(tex_layers, modes)):
        plan, crop_y, k_l, setup = None, 0, None, None
        if mode == "march":
            lay, plan, crop_y, k_l = _plan_march_layer(
                projector, idx, lay, cfg, num_planes, cxs, sk2, out_w,
                out_h, dx_pad, view=view)
        elif mode == "sweep":
            setup = (k_sweep, *sweep_opts)
            lay = dict(lay, sweep_invz=_sweep_tables(
                projector, tex_layers, k_sweep)[idx])
        else:
            _, setup, extra = planned[idx]
            if mode in ("target", "scaled"):
                extra = dict(extra, packed=_packed_texture(lay))
            lay = dict(lay, **extra)
        layers.append(lay)
        setups.append(setup)
        plans.append(plan)
        crops.append(crop_y)
        nums.append(k_l)
    return layers, setups, plans, crops, nums


def _march_sources(lay, plan, crop_y):
    """The march tier's source pipeline: the frustum-skew y pre-lerp by
    the layer's doff[1] (before the outpaint crop: the shift must read
    the real outpaint texels, not crop-edge replicas), then the center
    crop of a taller (outpainted) layer to the output height. A zero
    shift is skipped: the lerp would return the texels unchanged."""
    rgb_l, disp_l, mask_l = lay["rgb"], lay["disp"], lay["mask"]
    dy = lay["doff"][1]
    if dy:
        rgb_l, disp_l, mask_l = (
            _sweep_march.preshift_source(t, 0.0, dy)
            for t in (rgb_l, disp_l, mask_l)
        )
    if crop_y:
        rows = slice(crop_y, crop_y + plan.out_h)
        rgb_l, disp_l, mask_l = rgb_l[rows], disp_l[rows], mask_l[rows]
    return rgb_l, disp_l, mask_l


def _march_pack(lay, plan, crop_y):
    """One CUDA 'march' layer's pose-independent kernel inputs: the source
    it marches (_march_sources), prepare_translation_src's pack of it and
    the (r8, r32) row skip tables of that source (for a y-preshifted,
    skewed source its rows mix two texture rows, so the texture's own
    tables would be stale). Built once and cached with the texture, per
    (mask, float32 y shift, crop, plan): the pack holds the mask, and a
    stereo call marches the eroded one (_eroded_mask) through the same
    cache as mono calls the texture's. The entry keeps the mask alive, so
    its id cannot be reused while the key stands."""
    mask = lay["mask"]
    key = (id(mask), float(np.float32(lay["doff"][1])), crop_y, plan)
    cache = lay["march_packs"]
    entry = _lru_get(cache, key, "march_pack")
    if entry is not None:
        return entry[1]
    srcs = _march_sources(lay, plan, crop_y)
    pack = (srcs, prepare_translation_src(*srcs, plan),
            _sweep_march.row_skip_tables(srcs[1], lay["izmin_host"],
                                         lay["izmax_host"])[1:])
    _lru_put(cache, _MARCH_PACK_MAX, key, (mask, pack))
    return pack


def _eroded_mask(lay):
    """The stereo discard mask of one cached texture layer
    (erode_mask_for_stereo: erode + threshold replaces isMaskAround's 9
    reads), computed lazily on the first stereo call and kept in the
    layer's texture-cache entry, so it is keyed and evicted with the
    texture it was eroded from and mono-only callers never pay for it."""
    if "eroded_mask" not in lay:
        lay["eroded_mask"] = _sweep_march.erode_mask_for_stereo(lay["mask"])
    return lay["eroded_mask"]


def _packed_texture(lay):
    """The pack_rgbm texture (10-bit colour and the mask bit) of one
    cached texture layer, which the target and scaled epilogues fetch
    from: packed on the first call that routes the layer to either tier
    and kept in the layer's texture-cache entry, so it is keyed and
    evicted with the texture it was packed from, and a caller that never
    takes those tiers never holds one. It packs the texture's own mask:
    only the mono calls' epilogue route reads it (a stereo eye may march
    the eroded mask, and packs its own)."""
    if "packed" not in lay:
        lay["packed"] = pack_rgbm(lay["rgb"], lay["mask"])
    return lay["packed"]


def _attach_march_prep(layers, modes, plans, crops):
    """Hoist the march's pose-independent source prep out of the
    pose-chunk loop: the cached _march_pack of each 'march' layer, whose
    source, pack and row tables the kernel reads. CUDA path only (the CPU
    twin reads the textures)."""
    out = []
    with profiling.span("lif.prep"):
        for lay, mode, plan, crop_y in zip(layers, modes, plans, crops):
            if mode != "march" or lay["disp"].device.type != "cuda":
                out.append(lay)
                continue
            srcs, prep, rows = _march_pack(lay, plan, crop_y)
            out.append(dict(lay, march_src=srcs, march_prep=prep,
                            march_rows=rows))
    return out


def _balanced_chunk(batch, pose_chunk):
    """Balanced pose-chunk size: ceil(batch / n_chunks) for the chunk
    count the nominal size implies — e.g. batch=120 at pose_chunk=48
    renders 3 x 40 instead of 48 + 48 + 24."""
    if not pose_chunk or batch <= pose_chunk:
        return pose_chunk
    n_chunks = -(-batch // pose_chunk)
    return -(-batch // n_chunks)


def _pose_chunks(batch, pose_chunk):
    """The slices of a batch's balanced pose chunks of at most
    `pose_chunk` poses (None or 0: one chunk), a bound on the per-chunk
    intermediates."""
    size = batch
    if pose_chunk and batch > pose_chunk:
        size = _balanced_chunk(batch, pose_chunk)
    return [slice(s, s + size) for s in range(0, batch, size)]


def _chunk_layer(lay, sl):
    """A layer dict with its per-pose entries (_PP_KEYS) cut to a chunk."""
    return dict(lay, **{k: lay[k][sl] for k in _PP_KEYS if k in lay})


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
        tplan = _lru_get(_TARGET_NEIGHBORHOOD_CACHE, nkey,
                         "target_neighborhood")
        if tplan is None:
            tplan = _sweep_target.plan_from_extents(*src, bext)[0]
            _lru_put(_TARGET_NEIGHBORHOOD_CACHE,
                     _TARGET_NEIGHBORHOOD_CACHE_MAX, nkey, tplan)
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
    extras = {
        "pose_sc": torch.as_tensor(poses, device=device),
        "grids": torch.as_tensor(grids, device=device),
    }
    profiling.host_sync("sync.upload.poses", extras["pose_sc"].device)
    profiling.host_sync("sync.upload.grids", extras["grids"].device)
    return "target", (tplan, k_t), extras


def _plan_march_tier(lay, f2_host, out_w, out_w_true, out_h, pos_b, rot_b,
                     rotated, cfg, explicit_planes, device, dx_user=0.0,
                     sk1=None, sk2=None):
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
        with profiling.span("lif.plan.scaled"):
            plan = _sweep_scaled.scaled_plan(
                lay["w"], lay["h"], out_w, out_h, lay["focal_host"], fr,
                float(np.abs(pos_b[:, 0]).max()),
                float(np.abs(pos_b[:, 1]).max()),
                float(min(pos_b[:, 2].min(), 0.0)),
                float(max(pos_b[:, 2].max(), 0.0)),
                lay["izmin_host"], lay["izmax_host"],
                dx_user=dx_user + float(d[0]), dy_user=float(d[1]),
            )
            grids, k_l = _sweep_scaled.parallax_step_grids_batch(
                lay["focal_host"], pos_b, fr, out_w, out_h,
                lay["izmin_host"], lay["izmax_host"],
                step_px=cfg.rotated_step_px, num_planes=explicit_planes,
            )
            grids_t = torch.as_tensor(grids, device=device)
            profiling.host_sync("sync.upload.grids", grids_t.device)
        return (
            "scaled",
            (plan, k_l, fr, dx_user + float(d[0]), float(d[1])),
            {"grids": grids_t},
        )
    if dx_user == 0.0 and not skewed:
        with profiling.span("lif.plan.target"):
            key = (
                lay["w"], lay["h"], out_w_true, out_h, lay["focal_host"],
                f2_host, lay["izmin_host"], lay["izmax_host"],
                cfg.target_step_px, explicit_planes,
                rot_b.tobytes(), pos_b.tobytes(), str(device),
            )
            entry = _lru_get(_TARGET_PLAN_CACHE, key, "target_plan")
            if entry is None:
                entry = _plan_target_entry(
                    lay, f2_host, out_w_true, out_h, rot_b, pos_b,
                    cfg, explicit_planes, device,
                ) or "ineligible"
                _lru_put(_TARGET_PLAN_CACHE, _TARGET_PLAN_CACHE_MAX, key,
                         entry)
        if entry != "ineligible":
            return entry
    sk1_t = (float(sk1[0]), float(sk1[1]))
    sk2_t = (float(sk2[0]), float(sk2[1]))
    plan, wi, hi, aligned, grids, k_l, skip = _rotated_march.plan_rotated(
        lay["w"], lay["h"], out_w_true, out_h, lay["focal_host"], f2_host,
        rot_b, pos_b, lay["izmin_host"], lay["izmax_host"],
        step_px=cfg.rotated_step_px, num_planes=explicit_planes,
        sk1=sk1_t, sk2=sk2_t,
    )
    grids = np.zeros((len(pos_b), 1), np.float32) if skip else grids
    extras = {
        "aligned": torch.as_tensor(aligned, dtype=torch.float32,
                                   device=device),
        "grids": torch.as_tensor(grids, device=device),
    }
    profiling.host_sync("sync.upload.poses", extras["aligned"].device)
    profiling.host_sync("sync.upload.grids", extras["grids"].device)
    return "rotated", (plan, wi, hi, max(k_l, 1), skip, sk1_t, sk2_t), extras


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
        ok = _lru_get(_TARGET_OK_CACHE, key, "target_ok")
        if ok is None:
            try:
                _sweep_target.plan_from_extents(*dims, bext)
                ok = True
            except ValueError:
                ok = False
            _lru_put(_TARGET_OK_CACHE, _TARGET_OK_CACHE_MAX, key, ok)
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
    hit = _lru_get(_TRANSPOSED_CACHE, key, "transposed",
                   lambda e: all(a is b for a, b in zip(e[0], refs)))
    if hit is not None:
        return hit[1]
    with profiling.span("lif.prep"):
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
    raw=False,
    out=None,
    first=True,
    last=True,
    background=None,
    to_srgb=False,
):
    """ONE LDI layer's pose-batched render through its routed tier — the
    tier switch, shared by the mono batch and the stereo cores. c1_b
    (B, 3) and rot_b (B, 3, 3) are the host pose batch.
    'march': the lateral translation on its (B, K) plane tables
    `plane_invz`, with the layer's constant
    source shift `doff` (the width pad's dx and the skew fold; see
    render_fast_batch), from the hoisted march pack where
    _attach_march_prep attached one; 'scaled': the aligned march
    with its setup (plan, K, fr, dx, dy) and per-pose ladders in `lay`;
    'target': the target-ray march with its setup (plan, K) and the
    per-pose pose packs and ladders in `lay`; 'rotated': the two-phase
    march with its setup (plan, wi, hi, K, skip_phase_a, sk1, sk2) and the
    aligned positions and ladders in `lay`, rendered at the true width
    out_w; 'sweep': the plane sweep, pose by pose, with its setup (K,
    chunk, exact_color, rotated) and its (K,) plane table in
    lay['sweep_invz'] (render_rotated for a rotated batch, else
    render_sweep_aligned). Returns the (B, H, W, 4) premultiplied RGBA
    over a zero background, or with raw=True every march tier's (rgba,
    alpha, hit, invz*) tuple: straight colour, alpha, hit and the solved
    inverse depth, each with a leading pose axis (the stereo blend
    consumes them; the sweep has no raw outputs, and no stereo or fused
    plan routes to it).

    out: _fast_batch_core's in-place route, for a 'march', 'target' or
    'scaled' layer: the tier's epilogue kernel (its plain version on the
    CPU) finishes the layer into `out`, the call's (B, H, W_true, 4)
    frames of the chunk, over the layers in front unless `first`, over
    `background` and to sRGB if `last`, the target and scaled fetches from
    the layer's _packed_texture; returns out."""
    zero_bg = np.zeros(4, np.float32)
    if out is None:
        background, to_srgb, into = zero_bg, False, {}
    else:
        into = dict(out=out, first=first, last=last)
        if mode != "march":
            into["packed"] = lay["packed"]
    if mode == "sweep":
        with profiling.span("lif.sweep"):
            return _sweep_batch(lay, setup, c1_b, rot_b, f2, out_w, out_h,
                                feathering=feathering, mask_mode=mask_mode)
    if mode == "scaled":
        splan, k_s, fr, dxu, dyu = setup
        return _sweep_scaled.render_scaled_fetch_batch(
            lay["rgb"], lay["disp"], lay["mask"], lay["izmin_host"],
            lay["izmax_host"], c1_b, lay["focal_host"], fr, lay["grids"],
            background, splan, k_s, feathering=feathering,
            mask_mode=mask_mode, to_srgb=to_srgb, refine=rot_refine, raw=raw,
            dx_user=dxu, dy_user=dyu, skip_tables=lay.get("skip_scaled"),
            **into,
        )
    if mode == "rotated":
        rplan, wi, hi, k_r, skip_a, sk1_t, sk2_t = setup
        return _rotated_march.render_rotated_march_batch(
            lay["rgb"], lay["disp"], lay["mask"], lay["izmin_host"],
            lay["izmax_host"], lay["focal_host"], c1_b, rot_b,
            lay["aligned"], f2, lay["grids"], zero_bg, rplan, k_r, out_w,
            out_h, wi, hi, feathering=feathering, mask_mode=mask_mode,
            to_srgb=False, refine=rot_refine, raw=raw, skip_phase_a=skip_a,
            sk1=sk1_t, sk2=sk2_t, skip_tables=lay.get("skip_scaled"),
        )
    if mode == "target":
        tplan, k_t = setup
        return _sweep_target.render_target_fetch_batch(
            lay["rgb"], lay["disp"], lay["mask"], lay["izmin_host"],
            lay["izmax_host"], lay["pose_sc"], lay["grids"], background,
            tplan, k_t, feathering=feathering, mask_mode=mask_mode,
            to_srgb=to_srgb, raw=raw, refine=t_refine,
            skip_tables=lay.get("skip_target"), **into,
        )
    if mode != "march":
        raise ValueError(f"unknown tier: {mode!r}")
    if "march_src" in lay:  # hoisted (CUDA): the cached pack
        rgb_l, disp_l, mask_l = lay["march_src"]
    else:
        rgb_l, disp_l, mask_l = _march_sources(lay, plan, crop_y)
    return _sweep_march.render_translation_batch(
        rgb_l, disp_l, mask_l, lay["izmin_host"], lay["izmax_host"],
        c1_b, lay["focal_host"], lay["plane_invz"], background,
        plan=plan, num_planes=k_l, refine=refine, feathering=feathering,
        mask_mode=mask_mode, to_srgb=to_srgb, raw=raw, offset=lay["doff"],
        crop_y=crop_y, prepared=lay.get("march_prep"),
        skip_rows=lay.get("march_rows"), **into,
    )


def _sweep_batch(lay, setup, c1_b, rot_b, f2, out_w, out_h, *, feathering,
                 mask_mode):
    """One LDI layer's pose batch on the plane sweep (lif_tpu's sweep
    branch of _fast_chunk_body): the sweep multiplies the mask into alpha,
    so mask_mode='none' feeds a ones mask; 'hard' has no sweep equivalent.
    Returns (B, H, W, 4) premultiplied RGBA over a zero background."""
    k_s, chunk, exact_color, rotated = setup
    if mask_mode == "hard":
        raise ValueError(
            "mask_mode='hard' has no sweep equivalent; this layer fell back "
            "to the sweep"
        )
    mask = torch.ones_like(lay["mask"]) if mask_mode == "none" else lay["mask"]
    common = dict(
        out_w=out_w, out_h=out_h, focal1=lay["focal_host"], num_planes=k_s,
        chunk=chunk, feathering=feathering, to_srgb=False,
        plane_invz=lay["sweep_invz"],
    )
    zero_bg = np.zeros(4, np.float32)
    frames = [
        _sweep_fast.render_rotated(
            lay["rgb"], lay["disp"], mask, lay["izmin_host"],
            lay["izmax_host"], c1, rot, f2, zero_bg, **common)
        if rotated else
        _sweep_fast.render_sweep_aligned(
            lay["rgb"], lay["disp"], mask, lay["izmin_host"],
            lay["izmax_host"], c1, f2, zero_bg, exact_color=exact_color,
            **common)
        for c1, rot in zip(c1_b, rot_b)
    ]
    return torch.stack(frames)


@profiling.entry
def render_fast_batch(
    projector: Projector,
    cameras: Sequence[Camera],
    background=None,
    feathering: float | None = None,
    to_srgb: bool | None = None,
    num_planes: int | None = None,
    chunk: int | None = None,
    exact_color: bool = False,
    method: str = "auto",
    mask_mode: str | None = None,
    refine: int | None = None,
    config: RenderConfig | None = None,
    return_tiers: bool = False,
    _transpose: bool = True,
    _poses: slice | None = None,
):
    """Render MANY novel views; returns (B, H, W, 4) on the projector's
    device (GL-oriented, row 0 = bottom).

    The port of lif_tpu's production entry point, with lif_tpu's per-layer
    tier routing:
      * 'march': LATERAL batches (no relative rotation, translation along
        x only) on march-eligible layers (matched focal, even outpaint
        margins), on config.plane_mode's grid: 'snap' (per-pose
        integer-parallax planes), or 'uniform' / 'hybrid' (one table of
        num_planes planes, config.march_planes by default, shared by
        the batch). Frustum skew (sk1 source, sk2 camera) is the
        constant pixel shift d = -f1*(sk1 - sk2) there: its x part
        rides the snap phase and the warp tables, its y part a one-time
        bilinear pre-shift of the source (before the outpaint crop),
        lif_tpu's fold; an unknown plane_mode raises ValueError;
      * 'scaled': every other unrotated batch (y/z translation, dolly,
        zoom) and lateral layers that are not march-eligible;
      * 'target': rotated YAW-family batches (each layer plans with its
        own source dims); PITCH-family batches, which fail the target
        planner upright, render transposed: source and cameras x<->y
        swapped, the height padded to a 128-multiple, the pad sliced off
        and the axes swapped back on the device;
      * 'rotated': the two-phase fallback for rotated batches outside the
        target tier (yaw + pitch together, roll, skewed frustums);
      * 'sweep': a layer no march tier covers (method='auto' warns
        TierFallbackWarning with the planner's reason; the transposed
        route is tried first for a rotated batch), and every layer with
        method='sweep': the plane sweep on the layer's cached 'hybrid'
        plane table (num_planes or config.sweep_planes planes, `chunk` per
        matrix product, config.sweep_chunk by default), pose by pose —
        render_rotated for a rotated batch, else render_sweep_aligned,
        with exact_color's first-crossing colour fetch. The sweep cannot
        apply frustum skew or mask_mode='hard' (ValueError), and
        method='march' raises ValueError where a layer would sweep.
    Non-8-divisible widths render a padded band on 'march'/'scaled' and
    slice the true width; the pad is dropped when a layer takes another
    tier. On CUDA each march layer launches its kernel once per pose
    chunk; the sweep launches none. The layers are over-composited front
    to back.

    return_tiers=True returns (images, tiers) with the per-layer tier.
    Batches larger than config.pose_chunk render in balanced chunks (a
    bound on the per-chunk intermediates, nothing more). All cameras must
    share width/height/focal/skew; poses may vary. plan_tiers gives the
    planning alone. `_poses`, a slice of the batch, renders only those
    poses under the whole batch's plan (the frame-sharded path,
    parallel.sharding.render_fast_trajectory_sharded).
    """
    cfg = config or DEFAULT_CONFIG
    background = cfg.background if background is None else background
    feathering = cfg.feathering if feathering is None else feathering
    to_srgb = cfg.to_srgb if to_srgb is None else to_srgb
    chunk = cfg.sweep_chunk if chunk is None else chunk
    refine = cfg.march_refine if refine is None else refine
    with profiling.span("lif.plan"):
        tp = plan_tiers(projector, cameras, cfg, num_planes, method=method)
        cam0 = cameras[0]
        pos_b, rot_b, planned = tp.pos_b, tp.rot_b, tp.planned
        out_w_eff, dx_pad = tp.out_w_eff, tp.dx_pad
        mask_mode = _default_mask_mode(projector, mask_mode)
        modes = [p[0] for p in planned]
        transpose = (
            _transpose
            and tp.rotated
            and method != "sweep"
            and any(m in ("rotated", "sweep") for m in modes)
            and _transposed_target_ok(tp.tex_layers, tp.f2_host, cam0,
                                      tp.rot_b, tp.pos_b)
        )
    if transpose:
        return _render_transposed(
            projector, cameras, return_tiers, background=background,
            feathering=feathering, to_srgb=to_srgb, num_planes=num_planes,
            chunk=chunk, exact_color=exact_color, method=method,
            mask_mode=mask_mode, refine=refine, config=config,
            _poses=_poses,
        )
    if method == "march" and "sweep" in modes:
        raise ValueError(
            "method='march' needs poses the march tiers cover (lateral, "
            "aligned xyz/zoom, or bounded rotation with matched-focal "
            "layers); use method='auto' to fall back automatically"
        )
    if tp.skewed and "sweep" in modes:
        raise ValueError(
            "skewed frustums need every layer on a march tier (matched "
            "focal and dims) — the sweep fallback cannot apply the "
            "frustum shift"
        )
    for mode in modes:
        profiling.count(_ROUTE_COUNTERS[mode])

    with profiling.span("lif.plan"):
        layers, setups, plans, crops, nums = _plan_layers(
            projector, tp.tex_layers, modes, cfg, num_planes, pos_b[:, 0],
            cam0.skew, out_w_eff, cam0.height, dx_pad,
            (chunk, exact_color, tp.rotated), planned)
    if _poses is not None:
        layers = [_chunk_layer(lay, _poses) for lay in layers]
        pos_b, rot_b = pos_b[_poses], rot_b[_poses]
    out = _fast_batch_core(
        layers, modes, setups, pos_b, rot_b, background, plans=plans,
        nums=nums, crops=crops, refine=refine, rot_refine=cfg.rotated_refine,
        t_refine=cfg.target_refine, feathering=feathering,
        mask_mode=mask_mode, to_srgb=to_srgb, f2=tp.f2_host,
        out_h=cam0.height, out_w_true=cam0.width, pose_chunk=cfg.pose_chunk,
    )
    return (out, tuple(modes)) if return_tiers else out


class TierPlan(NamedTuple):
    """How render_fast_batch plans a pose batch, before the pitch route's
    transpose: the per-layer (mode, setup, per-pose device extras) of the
    tier cascade, with the inputs it was planned from."""

    tex_layers: list  # _prepared_textures, one dict per LDI layer
    planned: list  # per layer (mode, setup, extras); 'sweep': (None, {})
    pos_b: np.ndarray  # (B, 3) relative projector positions
    rot_b: np.ndarray  # (B, 3, 3) relative rotations
    rotated: bool
    skewed: bool
    f2_host: float  # camera focal, px
    out_w_eff: int  # band width of 'march'/'scaled' (the width pad)
    dx_pad: float  # the pad's constant x-offset


def _intrinsics_mismatch(cameras) -> str | None:
    """None where every camera has cameras[0]'s width, height, focal (to
    1e-6 px) and skew (np.allclose), checked for the batch at once; else
    what the first camera that differs gets wrong: 'dims' (width, height
    or focal) before 'skew', as a per-camera loop would find it."""
    cam0 = cameras[0]
    dims = np.array([(c.width, c.height) for c in cameras])
    focal = np.array([float(c.focal_px) for c in cameras])
    skews = [np.asarray(c.skew) for c in cameras]
    if len({s.dtype for s in skews}) == 1:
        skew_off = ~np.isclose(np.stack(skews), skews[0]).all(axis=-1)
    else:  # each pair in its own promoted precision, as np.allclose does
        skew_off = np.array([not np.allclose(s, skews[0]) for s in skews])
    skew_off[0] = False  # a NaN skew is not close to itself
    dims_off = ((dims != (cam0.width, cam0.height)).any(axis=1)
                | (np.abs(focal - float(cam0.focal_px)) > 1e-6))
    off = dims_off | skew_off
    if not off.any():
        return None
    return "dims" if dims_off[off.argmax()] else "skew"


class _Poses(NamedTuple):
    """A camera batch's poses relative to one projector (_read_poses)."""

    pos_b: np.ndarray  # (B, 3) relative projector positions, float64
    rot_b: np.ndarray  # (B, 3, 3) relative rotations, float64
    rotated: bool  # some relative rotation is off identity by over 1e-5
    lateral: bool  # unrotated, with |y| and |z| under 1e-9 at every pose


def _read_poses(projector, cameras) -> _Poses:
    """Where a camera batch stands relative to the projector: one
    relative_view_pose a camera (float64 host math, so each cx is the
    single view's bit for bit), and the two decisions every fast entry
    point routes on, made here once: `rotated`, and `lateral`, the
    lateral march's pose family (no relative rotation, translation along
    x only)."""
    pos_list, rot_list = zip(*(
        relative_view_pose(projector.position, projector.rotation,
                           cam.position, cam.rotation)
        for cam in cameras
    ))
    pos_b, rot_b = np.stack(pos_list), np.stack(rot_list)
    rotated = not (np.abs(rot_b - _EYE3) <= _ROT_TOL).all()
    lateral = not rotated and bool((np.abs(pos_b[:, 1:]) < 1e-9).all())
    return _Poses(pos_b, rot_b, rotated, lateral)


def plan_tiers(projector: Projector, cameras: Sequence[Camera],
               config: RenderConfig | None = None,
               num_planes: int | None = None,
               method: str = "auto") -> TierPlan:
    """Plan a pose batch as render_fast_batch does (relative poses, the
    per-layer tier cascade, the width pad) without rendering it. The
    'scaled' setup is (plan, K, fr, dx_user, dy_user) with the ladders in
    extras['grids']; the 'rotated' setup is (plan, wi, hi, K,
    skip_phase_a, sk1, sk2) with extras['aligned'] and extras['grids'];
    the 'target' setup is (plan, K); 'march' and 'sweep' plan later, per
    call. With method='auto' or 'march' a layer no march tier covers is
    'sweep' and warns TierFallbackWarning with the planner's reason (as
    lif_tpu's _layer_mode); method='sweep' plans every layer 'sweep'.
    Raises what render_fast_batch raises for cameras it cannot batch."""
    cfg = config or DEFAULT_CONFIG
    if method not in ("auto", "march", "sweep"):
        raise ValueError(f"unknown method: {method!r}")
    if len(cameras) == 0:
        raise ValueError("render_fast_batch needs at least one camera")
    cam0 = cameras[0]
    if _intrinsics_mismatch(cameras):
        raise ValueError(
            "render_fast_batch cameras must share intrinsics "
            "(width/height/focal/skew)"
        )

    pos_b, rot_b, rotated, lateral = _read_poses(projector, cameras)
    sk1 = np.asarray(projector.skew, np.float64)
    sk2 = np.asarray(cam0.skew, np.float64)
    skewed = bool(np.abs(sk1 - sk2).sum() > 1e-12)
    tex_layers = _prepared_textures(projector)
    f2_host = float(cam0.focal_px)
    if lateral and method != "sweep":
        _check_plane_mode(cfg)

    def layer_mode(idx, lay, out_w_eff, dx_pad):
        """Per-layer tier: 'march' (lateral, on config.plane_mode's grid),
        else the non-lateral cascade, else 'sweep' (with lif_tpu's
        warning)."""
        if method == "sweep":
            return "sweep", None, {}
        if lateral and _march_eligible(lay, f2_host, out_w_eff, cam0.height,
                                       out_w_true=cam0.width):
            return "march", None, {}
        try:
            return _plan_march_tier(
                lay, f2_host, out_w_eff, cam0.width, cam0.height, pos_b,
                rot_b, rotated, cfg, num_planes,
                projector.device, dx_user=dx_pad, sk1=sk1, sk2=sk2,
            )
        except ValueError as err:
            _warn_sweep_fallback(idx, err)
            return "sweep", None, {}

    # non-8-divisible widths: the band tiers render a wpad-wider band with
    # a constant wpad/2 x-offset, then slice the true width. Any other
    # tier renders around the true image center, so the pad is dropped
    # and only the band-tier layers re-plan.
    wpad = _width_pad(cam0.width)
    out_w_eff, dx_pad = cam0.width + wpad, wpad / 2.0
    planned = [layer_mode(i, lay, out_w_eff, dx_pad)
               for i, lay in enumerate(tex_layers)]
    if wpad and not all(p[0] in ("march", "scaled") for p in planned):
        out_w_eff, dx_pad = cam0.width, 0.0
        planned = [
            layer_mode(i, lay, out_w_eff, dx_pad)
            if p[0] in ("march", "scaled") else p
            for i, (lay, p) in enumerate(zip(tex_layers, planned))
        ]
    return TierPlan(tex_layers, planned, pos_b, rot_b, rotated, skewed,
                    f2_host, out_w_eff, dx_pad)


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
    refine, rot_refine, t_refine, feathering, mask_mode, to_srgb, f2,
    out_h, out_w_true, pose_chunk,
):
    """The body of render_fast_batch and of render_fast_view's lateral
    path: hoists the march's source prep, then renders balanced pose
    chunks of at most `pose_chunk` poses (a bound on the per-chunk
    intermediates; None: one chunk) and slices the width pad off. A call
    whose every layer has an epilogue kernel (_fuses_epilogue) finishes
    its frames in place instead."""
    layers = _attach_march_prep(layers, modes, plans, crops)
    tier_kw = dict(
        refine=refine, rot_refine=rot_refine, t_refine=t_refine,
        feathering=feathering, mask_mode=mask_mode,
    )
    tiers = list(zip(layers, modes, setups, plans, nums, crops))
    chunks = _pose_chunks(len(c1_b), pose_chunk)
    if _fuses_epilogue(modes):
        # the call's frames allocated once; each layer of each chunk
        # finished into its rows by its tier's epilogue kernel, so no frame
        # is copied after it is written and the width pad is never stored
        out = torch.empty((len(c1_b), out_h, out_w_true, 4),
                          dtype=torch.float32,
                          device=layers[0]["disp"].device)
        for sl in chunks:
            with profiling.span("lif.chunk"):
                for idx, (lay, mode, setup, plan, k_l, crop_y) in enumerate(
                    tiers
                ):
                    _layer_tier_batch(
                        _chunk_layer(lay, sl), mode, setup, plan, k_l,
                        crop_y, c1_b[sl], rot_b[sl], f2, out_w_true, out_h,
                        **tier_kw, out=out[sl], first=idx == 0,
                        last=idx == len(tiers) - 1, background=background,
                        to_srgb=to_srgb,
                    )
        return out
    outs = []
    for sl in chunks:
        # front-to-back LDI over-compositing of the chunk's layers
        with profiling.span("lif.chunk"):
            result_rgb = result_a = None
            for lay, mode, setup, plan, k_l, crop_y in tiers:
                layer = _layer_tier_batch(
                    _chunk_layer(lay, sl), mode, setup, plan, k_l, crop_y,
                    c1_b[sl], rot_b[sl], f2, out_w_true, out_h, **tier_kw,
                )  # (B, H, W, 4), premultiplied
                with profiling.span("lif.composite"):
                    la = layer[..., 3]
                    if result_rgb is None:
                        result_rgb, result_a = layer[..., :3], la
                    else:
                        result_rgb = (result_rgb + (1.0 - result_a[..., None])
                                      * layer[..., :3])
                        result_a = result_a + (1.0 - result_a) * la
            with profiling.span("lif.composite"):
                outs.append(_composite.finish_over_background(
                    result_rgb, result_a, background, to_srgb
                ))
    out = outs[0] if len(outs) == 1 else torch.cat(outs)
    return out[:, :, :out_w_true, :] if out.shape[2] != out_w_true else out


def _fuses_epilogue(modes) -> bool:
    """Whether a mono call finishes its frames in place: every layer
    routed to a tier with an epilogue kernel ('march': the lateral
    epilogue; 'target' and 'scaled': the posed epilogue), on any device
    (the CPU finishes through the kernels' plain versions). A 'rotated'
    or 'sweep' layer keeps the call on the chain: per-chunk frames, their
    compositing and their concatenation."""
    return all(m in ("march", "target", "scaled") for m in modes)


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
    mask_mode = _default_mask_mode(projector, mask_mode)
    return _raycast.render_mono(
        *_view_args(projector, camera.position, camera.rotation),
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


def _default_mask_mode(projector: Projector, mask_mode: str | None) -> str:
    """mask_mode as given, or the reference default when None: 'multiply'
    for an LDI projector, else 'none'."""
    return mask_mode or ("multiply" if projector.num_layers > 1 else "none")


def _view_args(projector: Projector, position, rotation):
    """One view's arguments of ops.raycast.render_mono and
    ops.stereo.render_stereo, from the textures through rot1, for a camera
    at the world pose (position, rotation): the host fields, the
    baseline-normalized ranges (divided in float32, as lif_tpu divides
    them) and the camera-local projector pose."""
    pos, rot = relative_view_pose(projector.position, projector.rotation,
                                  position, rotation)
    baseline = np.float32(projector.baseline)
    return (
        projector.rgb, projector.disp, projector.mask, projector.layer_res,
        np.asarray(projector.invz_min, np.float32) / baseline,
        np.asarray(projector.invz_max, np.float32) / baseline,
        projector.focal, projector.skew, np.asarray(pos, np.float32),
        np.asarray(rot, np.float32),
    )


def render_stereo_view(
    left: Projector,
    right: Projector,
    camera: Camera,
    background=None,
    feathering: float | None = None,
    to_srgb: bool | None = None,
    num_steps: int | None = None,
    config: RenderConfig | None = None,
):
    """Render blending two projectors with the exact ray march (the stereo
    mode, render(mode='stereo')): ops.stereo.render_stereo over the first
    min(L_left, L_right) layers. Returns (H, W, 4) GL-oriented on the
    projectors' device. reference: RaycastPlane.ts:812-843 +
    rayCastStereoLDI.glsl. Unset keyword knobs resolve from `config`
    (DEFAULT_CONFIG when None)."""
    cfg = config or DEFAULT_CONFIG
    background = cfg.background if background is None else background
    feathering = cfg.feathering if feathering is None else feathering
    to_srgb = cfg.to_srgb if to_srgb is None else to_srgb
    num_steps = cfg.num_steps if num_steps is None else num_steps
    return _stereo.render_stereo(
        *_view_args(left, camera.position, camera.rotation),
        *_view_args(right, camera.position, camera.rotation),
        float(camera.focal_px), camera.skew, background,
        out_w=camera.width, out_h=camera.height,
        num_layers=min(left.num_layers, right.num_layers),
        feathering=feathering, num_steps=num_steps, to_srgb=to_srgb,
    )


@profiling.entry
def render_fast_view(
    projector: Projector,
    camera: Camera,
    background=None,
    feathering: float | None = None,
    to_srgb: bool | None = None,
    num_planes: int | None = None,
    chunk: int | None = None,
    exact_color: bool = False,
    method: str = "auto",
    mask_mode: str | None = None,
    refine: int | None = None,
    config: RenderConfig | None = None,
):
    """Render ONE novel view on the fast tiers — the production single-view
    path, lif_tpu's render_fast_view. Returns (H, W, 4) on the projector's
    device (GL-oriented, row 0 = bottom).

    Routing by pose, as lif_tpu routes it:
      * y-only translation (both world rotations identity, every layer at
        the camera's focal and dims; not method='sweep'): an x<->y
        transpose of source and camera onto the lateral march, the result
        swapped back;
      * any other non-lateral pose: render_fast_batch with a batch of one
        (the scaled, target and rotated tiers, and its sweep fallback);
        with method='sweep' the plane sweep directly (render_rotated for a
        rotated pose, else render_sweep_aligned);
      * a lateral pose: per layer, the plane march (on CUDA the lateral
        kernel, one launch per layer) on this pose's own snap_plane_table
        (or config.plane_mode's uniform / hybrid table, as
        render_fast_batch) where the layer is march-eligible, else (with
        TierFallbackWarning under 'auto') the plane sweep on the layer's
        'hybrid' table; with the width pad of a non-8-divisible width when
        every layer marches, the skew fold, LDI over-compositing and
        finish_over_background.

    method: 'auto', 'march' (ValueError where a layer is not
    march-eligible, as lif_tpu) or 'sweep'. exact_color and chunk (the
    sweep's planes per matrix product, config.sweep_chunk by default) are
    the sweep layers' options; num_planes, when given, sets the plane
    count of both tiers, as in render_fast_batch. Frustum skew needs every
    layer on the march.
    mask_mode: None -> the reference default (multiply for LDI projectors,
    taper-only for single-layer), or 'multiply' / 'none'; 'hard' raises
    ValueError on a sweep layer."""
    cfg = config or DEFAULT_CONFIG
    if method not in ("auto", "march", "sweep"):
        raise ValueError(f"unknown method: {method!r}")
    background = cfg.background if background is None else background
    feathering = cfg.feathering if feathering is None else feathering
    to_srgb = cfg.to_srgb if to_srgb is None else to_srgb
    chunk = cfg.sweep_chunk if chunk is None else chunk
    refine = cfg.march_refine if refine is None else refine
    with profiling.span("lif.plan"):
        poses = _read_poses(projector, [camera])
        pos_np, rotated = poses.pos_b[0], poses.rotated
        tex_layers = _prepared_textures(projector)
        f2_host = float(camera.focal_px)
        kw = dict(background=background, feathering=feathering,
                  to_srgb=to_srgb, num_planes=num_planes, chunk=chunk,
                  exact_color=exact_color, method=method,
                  mask_mode=mask_mode, refine=refine, config=config)

        # y-only translation: a transpose maps it onto the x-only march. Both
        # world rotations must be identity so the transposed world poses give
        # the swapped relative pose; every layer must be march-eligible
        transposed = (
            method != "sweep"
            and not rotated
            and abs(pos_np[0]) < 1e-9
            and abs(pos_np[2]) < 1e-9
            and abs(pos_np[1]) > 1e-9
            and np.allclose(projector.rotation, np.eye(3))
            and np.allclose(camera.rotation, np.eye(3))
            and all(
                abs(lay["focal_host"] - f2_host) < 1e-6 * f2_host
                and lay["w"] == camera.width
                and lay["h"] == camera.height
                for lay in tex_layers
            )
        )
    if transposed:
        cam_t = Camera.create(
            camera.height, camera.width, focal_px=f2_host,
            position=np.asarray(camera.position)[[1, 0, 2]],
            skew=np.asarray(camera.skew)[[1, 0]],
        )
        out = render_fast_view(_transposed_projector(projector), cam_t, **kw)
        return out.transpose(0, 1).contiguous()

    if method != "sweep" and not poses.lateral:
        return render_fast_batch(projector, [camera], **kw)[0]

    with profiling.span("lif.plan"):
        marching = method != "sweep"  # and, from here on, a lateral pose
        if marching:
            _check_plane_mode(cfg)
        mask_mode = _default_mask_mode(projector, mask_mode)
        sk1 = np.asarray(projector.skew, np.float64)
        sk2 = np.asarray(camera.skew, np.float64)
        skewed = bool(np.abs(sk1 - sk2).sum() > 1e-12)
        if skewed and not marching:
            raise ValueError(
                "skewed frustums are supported only on the lateral march "
                "path (no rotation, x-only translation)"
            )
        # equal nonzero skews cancel only for unrotated views; the rotated
        # sweep ignores skew
        if rotated and (np.abs(sk1).sum() + np.abs(sk2).sum()) > 1e-12:
            raise ValueError(
                "render_fast_view does not support skew on rotated poses; "
                "use render_mono_view (the exact march handles it)"
            )

        # non-8-divisible widths: march a wpad-wider band carrying a constant
        # wpad/2 x-offset and slice the true width, only when every layer
        # marches (a sweep layer renders around the true image centre)
        wpad = _width_pad(camera.width)
        out_w_eff, dx_pad = camera.width + wpad, wpad / 2.0

        def eligible(lay, w_eff):
            return marching and _march_eligible(lay, f2_host, w_eff,
                                                camera.height,
                                                out_w_true=camera.width)

        if wpad and not all(eligible(lay, out_w_eff) for lay in tex_layers):
            out_w_eff, dx_pad = camera.width, 0.0
        modes = []
        for idx, lay in enumerate(tex_layers):
            m = eligible(lay, out_w_eff)
            if not m and method == "auto":
                # stacklevel 4: past profiling.entry's wrapper, at the
                # caller of render_fast_view
                _warn_sweep_fallback(
                    idx, "layer is not march-eligible at this camera "
                    "(mismatched focal/dims or non-8-divisible width)",
                    stacklevel=4,
                )
            if method == "march" and not m:
                raise ValueError(
                    "method='march' needs a lateral view (no rotation/skew, "
                    "x-only translation, matched focal, output dims == layer "
                    "dims); use method='auto' to fall back automatically"
                )
            modes.append("march" if m else "sweep")
        if skewed and "sweep" in modes:
            raise ValueError(
                "skewed frustums need every layer on the march path "
                "(matched focal and dims)"
            )

        layers, setups, plans, crops, nums = _plan_layers(
            projector, tex_layers, modes, cfg, num_planes, poses.pos_b[:, 0],
            camera.skew, out_w_eff, camera.height, dx_pad,
            (chunk, exact_color, rotated), view=True)
    return _fast_batch_core(
        layers, modes, setups, poses.pos_b, poses.rot_b, background,
        plans=plans, nums=nums, crops=crops, refine=refine,
        rot_refine=cfg.rotated_refine, t_refine=cfg.target_refine,
        feathering=feathering, mask_mode=mask_mode, to_srgb=to_srgb,
        f2=f2_host, out_h=camera.height, out_w_true=camera.width,
        pose_chunk=None,
    )[0]


def render_depth_fast(
    projector: Projector,
    camera: Camera,
    config: RenderConfig | None = None,
):
    """Solved surface inverse depth at a novel pose, in LIF units (1/m
    when baseline is meters): the lateral march's raw invz* (layer 0, on
    CUDA the lateral kernel) times the baseline, 0 where no surface was
    hit. Returns (H, W) float32 on the projector's device.

    The depth-map counterpart of render_fast_view (lif_tpu's
    render_depth_fast), e.g. for authoring a synthesized view's
    inv_z_map. Lateral poses only, at layer 0's focal and dims; as in
    lif_tpu, frustum skew is not applied. `config` is accepted for
    lif_tpu's signature."""
    poses = _read_poses(projector, [camera])
    if not poses.lateral:
        raise ValueError("render_depth_fast needs a lateral (x-only) pose")
    lay = _prepared_textures(projector)[0]
    if (
        abs(lay["focal_host"] - float(camera.focal_px)) > 1e-6
        or lay["w"] != camera.width
        or lay["h"] != camera.height
    ):
        raise ValueError("render_depth_fast needs matched focal/dims")
    cx = float(poses.pos_b[0, 0])
    plan = _march_plan(lay, abs(cx), camera.width, camera.height)
    tab, k = _sweep_march.snap_plane_tables_batch(
        lay["focal_host"], [cx], lay["izmin_host"], lay["izmax_host"],
    )
    _, _, _, izs = _sweep_march.render_translation(
        lay["rgb"], lay["disp"], lay["mask"], lay["izmin_host"],
        lay["izmax_host"], poses.pos_b[0], lay["focal_host"],
        torch.as_tensor(tab[0], device=projector.device),
        np.zeros(4, np.float32), plan=plan, num_planes=k, mask_mode="none",
        to_srgb=False, raw=True, skip_rows=lay.get("skip_rows"),
    )
    return izs * float(np.float32(projector.baseline))


class _Eye(NamedTuple):
    """One eye of render_stereo_fast_batch, planned: its relative pose
    batch and, per layer, the dict it renders with its tier, setup,
    march plan, crop and plane count (_layer_tier_batch's arguments)."""

    pos_b: np.ndarray  # (B, 3) relative projector positions
    rot_b: np.ndarray  # (B, 3, 3) relative rotations
    layers: list
    modes: list
    setups: list
    plans: list
    crops: list
    nums: list


def _stereo_eye(projector, cameras, num_layers, mask_mode, cfg, num_planes):
    """Plan one eye as lif_tpu's stereo _eye_setup does: a lateral pose
    batch takes the plane march on config.plane_mode's grid
    (_march_tables) on each march-eligible layer (the skew fold of
    _march_fold, no width pad), every other layer the cascade of
    _plan_march_tier (scaled, target, rotated); stereo has no sweep
    fallback and no pitch transpose, and a batch no tier covers raises
    ValueError naming render_stereo_view. Each layer dict carries the mask
    it marches (the eroded stereo mask in the 'hard' mode) and the skew
    fold's constant shift `doff`, which _stretch_conf reads on every
    tier. Each layer counts route.<tier> for the tier it renders on, as
    render_fast_batch counts it."""
    cam0 = cameras[0]
    f2_host = float(cam0.focal_px)
    out_w, out_h = cam0.width, cam0.height
    poses = _read_poses(projector, cameras)
    _check_plane_mode(cfg)
    sk1 = np.asarray(projector.skew, np.float64)
    sk2 = np.asarray(cam0.skew, np.float64)
    eye = _Eye(poses.pos_b, poses.rot_b, [], [], [], [], [], [])
    for idx, lay in enumerate(_prepared_textures(projector)[:num_layers]):
        mask = _eroded_mask(lay) if mask_mode == "hard" else lay["mask"]
        plan, crop_y, k_l, setup = None, 0, None, None
        if poses.lateral and _march_eligible(lay, f2_host, out_w, out_h):
            mode = "march"
            lay, plan, crop_y, k_l = _plan_march_layer(
                projector, idx, lay, cfg, num_planes, poses.pos_b[:, 0],
                sk2, out_w, out_h)
        else:
            try:
                mode, setup, extra = _plan_march_tier(
                    lay, f2_host, out_w, out_w, out_h, poses.pos_b,
                    poses.rot_b, poses.rotated, cfg, num_planes,
                    projector.device, sk1=sk1, sk2=sk2,
                )
            except ValueError as err:
                raise ValueError(
                    "render_stereo_fast: pose family outside the march "
                    f"tiers ({err}); use render_stereo_view"
                ) from err
            d = -lay["focal_host"] * (sk1 - sk2)
            lay = dict(lay, doff=(float(d[0]), float(d[1])), **extra)
        profiling.count(_ROUTE_COUNTERS[mode])
        eye.layers.append(dict(lay, mask=mask))
        eye.modes.append(mode)
        eye.setups.append(setup)
        eye.plans.append(plan)
        eye.crops.append(crop_y)
        eye.nums.append(k_l)
    return eye


@profiling.entry
def render_stereo_fast_batch(
    left: Projector,
    right: Projector,
    cameras: Sequence[Camera],
    background=None,
    feathering: float | None = None,
    to_srgb: bool | None = None,
    num_planes: int | None = None,
    refine: int | None = None,
    config: RenderConfig | None = None,
    return_tiers: bool = False,
):
    """Fast two-view (stereo) rendering of a camera batch: lif_tpu's
    render_stereo_fast_batch. Returns (B, H, W, 4) on the projectors'
    device (GL-oriented).

    The exact stereo kernel's semantics (reference:
    rayCastStereoLDI.glsl:165-170, 368-436) on the march tiers: per layer,
    each eye's tier render with its raw outputs, the stretch-mark
    confidence of each, ops.stereo.occlusion_blend with the per-pose
    view_weight, then front-to-back LDI compositing, the background and
    the gamma (_stereo_core: one stereo epilogue kernel a layer and pose
    chunk where both eyes march). Each eye routes as _stereo_eye says:
    lateral poses on the plane march (on CUDA the lateral kernel, one
    launch per eye, layer and pose chunk), other poses on the scaled,
    target or rotated tier. Frustum skew (sk1 per eye, a shared sk2) rides
    every tier as in render_fast_batch. LDI pairs (more than one layer)
    take the dilated hard discard: each layer marches its eroded mask,
    and a tier keeps a hit where that mask reads >= 0.5; single layers
    take the taper only. All cameras must share width, height, focal and
    skew. Batches beyond config.pose_chunk render in balanced chunks.
    The lateral march takes config.plane_mode's grid, as the mono batch
    does.

    return_tiers=True returns (images, (left tiers, right tiers)).
    """
    cfg = config or DEFAULT_CONFIG
    background = cfg.background if background is None else background
    feathering = cfg.feathering if feathering is None else feathering
    to_srgb = cfg.to_srgb if to_srgb is None else to_srgb
    refine = cfg.march_refine if refine is None else refine
    if len(cameras) == 0:
        raise ValueError("render_stereo_fast_batch needs at least one camera")
    cam0 = cameras[0]
    mismatch = _intrinsics_mismatch(cameras)
    if mismatch == "dims":
        raise ValueError(
            "render_stereo_fast_batch cameras must share width/height/focal"
        )
    if mismatch == "skew":
        raise ValueError(
            "render_stereo_fast_batch cameras must share skew; batch "
            "per-eye frusta as separate calls"
        )
    num_layers = min(left.num_layers, right.num_layers)
    # the dilated hard discard where LDI masks exist
    # (rayCastStereoLDI.glsl:304-305); taper only for a single layer
    mask_mode = "hard" if num_layers > 1 else "none"
    with profiling.span("lif.plan"):
        eyes = [_stereo_eye(p, cameras, num_layers, mask_mode, cfg,
                            num_planes)
                for p in (left, right)]
        # per-pose blend weight: the render camera at the origin of its
        # frame
        w_r = _stereo.view_weight(np.zeros(3), eyes[0].pos_b,
                                  eyes[1].pos_b).to(left.device)
        profiling.host_sync("sync.upload.weights", w_r.device)
    out = _stereo_core(
        eyes, w_r, background,
        refine=refine, rot_refine=cfg.rotated_refine,
        t_refine=cfg.target_refine, feathering=feathering,
        mask_mode=mask_mode, to_srgb=to_srgb, f2=float(cam0.focal_px),
        out_w=cam0.width, out_h=cam0.height, pose_chunk=cfg.pose_chunk,
    )
    if return_tiers:
        return out, tuple(tuple(eye.modes) for eye in eyes)
    return out


def render_stereo_fast(left: Projector, right: Projector, camera: Camera,
                       **kw):
    """Single-pose fast stereo: a batch of one (render_stereo_fast_batch)."""
    return render_stereo_fast_batch(left, right, [camera], **kw)[0]


def _stereo_fuses(eyes, i) -> bool:
    """Whether layer i of a stereo call finishes in the stereo epilogue
    (ops/cuda/stereo_epilogue.py): both eyes march it on the lateral tier.
    A layer where either eye takes another tier keeps the chain: each
    eye's raw tier render, _stretch_conf, occlusion_blend."""
    return all(eye.modes[i] == "march" for eye in eyes)


def _stereo_transforms(eyes, sl, f2, out_w, out_h, device):
    """The chunk's confidence transforms of every layer and both eyes
    (conf_transforms, float32 on the host) as one (L, 2, B, 12) tensor on
    `device`: p row-major, then c_vec. On CUDA one pinned upload that
    rides the stream without a wait."""
    rows = []
    for i in range(len(eyes[0].layers)):
        for eye in eyes:
            lay = eye.layers[i]
            p, c_vec = _stereo_epilogue.conf_transforms(
                lay["focal_host"], lay["disp"].shape[1], lay["disp"].shape[0],
                eye.pos_b[sl], eye.rot_b[sl], f2, out_w, out_h)
            rows.append(torch.cat([p.reshape(len(p), 9), c_vec], dim=-1))
    rows = torch.stack(rows).reshape(len(eyes[0].layers), len(eyes), -1, 12)
    if device.type == "cuda":
        # pinned, so the copy rides the stream without a wait; the host
        # allocator keeps the block until the copy has run
        rows = rows.pin_memory().to(device, non_blocking=True)
    return rows


def _stereo_march(eye, i, poses, transforms, sl, refine):
    """Layer i of one eye of a stereo pose chunk on the lateral march
    (_lateral_march), raw, as a stereo_epilogue.StereoEye with the chunk's
    device poses and confidence transforms."""
    lay = _chunk_layer(eye.layers[i], sl)
    found, invz, rgba = _lateral_march(lay, eye.plans[i], eye.nums[i],
                                       eye.crops[i], eye.pos_b[sl], poses,
                                       refine)
    return _stereo_epilogue.StereoEye(
        found, invz, rgba, poses, eye.plans[i], lay["focal_host"],
        lay["doff"], eye.crops[i], lay["disp"], lay["izmin_host"],
        lay["izmax_host"], transforms)


def _stereo_core(eyes, w_r, background, *, refine, rot_refine, t_refine,
                 feathering, mask_mode, to_srgb, f2, out_w, out_h,
                 pose_chunk):
    """The body of render_stereo_fast_batch: hoists each eye's march
    source prep, allocates the (B, H, W, 4) output and, where a layer
    fuses (_stereo_fuses), uploads both eyes' poses once, then renders
    balanced pose chunks into it, layer by layer front to back. A layer
    both eyes march takes both lateral marches (_stereo_march) and the
    stereo epilogue (ops/cuda/stereo_epilogue.py: each eye's hit test and
    stretch-mark confidence, the occlusion fill and blend, the over onto
    the layers in front and, on the last layer, the background and sRGB;
    one kernel launch on the card, its plain version, the PyTorch chain,
    on the CPU, counted as epilogue.stereo.fused), its confidence
    transforms uploaded with the chunk's. Any other layer keeps the
    chain: both eyes' tiers with their raw outputs and _stretch_conf,
    then stereo_epilogue.blend_over_into the output (occlusion_blend,
    over, finish).
    Each layer blended in a chunk counts stereo.blend once (both eyes).
    w_r: (B,) float32 on the device."""
    eyes = [
        eye._replace(layers=_attach_march_prep(eye.layers, eye.modes,
                                               eye.plans, eye.crops))
        for eye in eyes
    ]
    n_layers = len(eyes[0].layers)
    fused = [_stereo_fuses(eyes, i) for i in range(n_layers)]
    device = eyes[0].layers[0]["disp"].device
    batch = len(w_r)
    out = torch.empty((batch, out_h, out_w, 4), dtype=torch.float32,
                      device=device)
    poses = None
    if any(fused):
        poses = _cuda_march.upload_poses(
            np.stack([eye.pos_b for eye in eyes]), device)
    tier_kw = dict(
        refine=refine, rot_refine=rot_refine, t_refine=t_refine,
        feathering=feathering, mask_mode=mask_mode, raw=True,
    )
    for sl in _pose_chunks(batch, pose_chunk):
        with profiling.span("lif.chunk"):
            tfs = (_stereo_transforms(eyes, sl, f2, out_w, out_h, device)
                   if any(fused) else None)
            for i in range(n_layers):
                into = dict(background=background, to_srgb=to_srgb,
                            first=i == 0, last=i == n_layers - 1)
                if fused[i]:
                    marched = [_stereo_march(eye, i, poses[e, sl],
                                             tfs[i, e], sl, refine)
                               for e, eye in enumerate(eyes)]
                    with profiling.span("lif.stereo.blend"):
                        profiling.count("stereo.blend")
                        profiling.count("epilogue.stereo.fused")
                        _stereo_epilogue.stereo_epilogue(
                            marched, w_r[sl], out[sl], feathering=feathering,
                            mask_mode=mask_mode, **into)
                    del marched
                    continue
                views, confs = [], []
                for eye in eyes:
                    lay = _chunk_layer(eye.layers[i], sl)
                    rgba, alpha, hit, invz = _layer_tier_batch(
                        lay, eye.modes[i], eye.setups[i], eye.plans[i],
                        eye.nums[i], eye.crops[i], eye.pos_b[sl],
                        eye.rot_b[sl], f2, out_w, out_h, **tier_kw,
                    )
                    views.append((rgba, alpha))
                    with profiling.span("lif.stereo.conf"):
                        confs.append(_stretch_conf(
                            lay, eye.pos_b[sl], eye.rot_b[sl], hit, invz,
                            f2, out_w, out_h))
                with profiling.span("lif.stereo.blend"):
                    profiling.count("stereo.blend")
                    _stereo_epilogue.blend_over_into(views, confs, w_r[sl],
                                                     out[sl], **into)
    return out


def _stretch_conf(lay, c1_b, rot_b, hit, invz, f2, out_w, out_h):
    """stereo_epilogue.stretch_conf for one layer dict of a stereo eye on
    any tier (its disparity texture, range and skew fold's shift `doff`),
    with the poses' transforms (conf_transforms) uploaded here. Returns
    (B, H, W) float32 confidence, 0 or 1."""
    disp = lay["disp"]
    hs, ws = disp.shape
    p, c_vec = _stereo_epilogue.conf_transforms(
        lay["focal_host"], ws, hs, c1_b, rot_b, f2, out_w, out_h)
    p, c_vec = p.to(disp.device), c_vec.to(disp.device)
    profiling.host_sync("sync.upload.poses", disp.device, 2)
    return _stereo_epilogue.stretch_conf(
        disp, lay["izmin_host"], lay["izmax_host"], lay["doff"], p, c_vec,
        hit, invz, out_w, out_h)


def render_fused_fast(projectors: Sequence[Projector], camera: Camera, **kw):
    """Multi-projector nearest-depth fusion at one pose: a batch of one
    (render_fused_fast_batch)."""
    return render_fused_fast_batch(projectors, [camera], **kw)[0]


class _FusedView(NamedTuple):
    """One projector of render_fused_fast_batch, planned: its relative
    pose batch, its mask mode and, per layer, the march's layer dict (with
    the per-pose snap grids and the skew fold's `doff`), plan and plane
    count."""

    pos_b: np.ndarray  # (B, 3) relative projector positions
    mask_mode: str
    layers: list
    plans: list
    nums: list


@profiling.entry
def render_fused_fast_batch(
    projectors: Sequence[Projector],
    cameras: Sequence[Camera],
    background=None,
    feathering: float | None = None,
    to_srgb: bool | None = None,
    num_planes: int | None = None,
    mask_mode: str | None = None,
    config: RenderConfig | None = None,
):
    """Multi-projector nearest-depth fusion on the lateral march for a
    batch of poses: lif_tpu's render_fused_fast_batch, the single-device
    counterpart of parallel.sharding.render_fused_projectors (the same
    merge on the exact march). Returns (B, H, W, 4) on the projectors'
    device (GL-oriented).

    Per projector: every LDI layer is marched with its raw outputs (on
    CUDA the lateral kernel, one launch per projector, layer and pose
    chunk), composited front to back with the reference mask semantics
    (mask_mode None: 'multiply' for an LDI projector, else 'none'), and
    the frontmost hit's ABSOLUTE inverse depth (the march's invz* on the
    baseline-normalized range, comparable across projectors) is kept.
    Across projectors: candidates within config.fuse_tol relative inverse
    depth of the frontmost surface blend with triangular weights
    (composite.fusion_weights; fuse_tol=0 is the hard nearest-wins merge with
    exact ties averaged). Frustum skew (sk1 per projector, a shared sk2)
    folds into each projector's march as in render_fast_batch.

    Every projector must take every camera laterally (no relative
    rotation, x-only translation) on march-eligible layers whose dims
    equal the camera's with an 8-divisible width; the cameras must share
    width, height, focal and skew. Other poses take
    parallel.sharding.render_fused_projectors. Batches beyond
    config.pose_chunk, or on CUDA beyond what the free device memory
    holds (_fused_pose_chunk), render in balanced chunks. Each
    projector marches config.plane_mode's grid, as the mono and stereo
    batches do."""
    cfg = config or DEFAULT_CONFIG
    background = cfg.background if background is None else background
    feathering = cfg.feathering if feathering is None else feathering
    to_srgb = cfg.to_srgb if to_srgb is None else to_srgb
    if len(cameras) == 0:
        raise ValueError("render_fused_fast_batch needs at least one camera")
    cam0 = cameras[0]
    if _intrinsics_mismatch(cameras):
        raise ValueError(
            "render_fused_fast_batch cameras must share "
            "width/height/focal/skew"
        )
    views = []
    with profiling.span("lif.plan"):
        for proj in projectors:
            views.append(_fused_view(proj, cameras, cfg, num_planes,
                                     mask_mode))
    return _fused_fast_core(
        views, background, refine=cfg.march_refine, feathering=feathering,
        to_srgb=to_srgb, fuse_tol=float(cfg.fuse_tol),
        pose_chunk=cfg.pose_chunk, out_h=cam0.height, out_w=cam0.width,
    )


def _fused_view(proj, cameras, cfg, num_planes, mask_mode) -> _FusedView:
    """Plan one projector of render_fused_fast_batch (its relative poses,
    and per layer the skew fold and the march's plane tables); raises
    ValueError for a pose or layer the lateral march cannot take."""
    cam0 = cameras[0]
    f2_host = float(cam0.focal_px)
    poses = _read_poses(proj, cameras)
    if not poses.lateral:
        raise ValueError(
            "render_fused_fast needs lateral poses; use "
            "parallel.sharding.render_fused_projectors for arbitrary poses"
        )
    _check_plane_mode(cfg)
    view = _FusedView(
        poses.pos_b, _default_mask_mode(proj, mask_mode), [], [], [])
    for idx, lay in enumerate(_prepared_textures(proj)):
        if not _march_eligible(lay, f2_host, cam0.width, cam0.height) or (
            lay["w"] != cam0.width or lay["h"] != cam0.height
        ):
            raise ValueError(
                "render_fused_fast needs matched focal/dims per layer "
                "and an 8-divisible width"
            )
        lay, plan, _, k_l = _plan_march_layer(
            proj, idx, lay, cfg, num_planes, poses.pos_b[:, 0], cam0.skew,
            cam0.width, cam0.height)
        view.layers.append(lay)
        view.plans.append(plan)
        view.nums.append(k_l)
    return view


# Device bytes the fused core holds per projector layer, output pixel and
# pose of a chunk on CUDA, where only the marches' outputs (24 bytes) and
# the output stay alive until the fused epilogue kernel finishes the
# chunk: rounded up from the 28.0 that chip_smoke.py's main path 10
# measures (the growth of max_memory_allocated from 8 to 16 cameras of 4
# one-layer projectors at 3840x2160, 0.865 GiB a camera; it fails if the
# growth exceeds this bound), on an NVIDIA H100 80GB HBM3 at 700 W.
_FUSED_BYTES_PER_LAYER_PX = 32


def _free_device_bytes(device) -> int | None:
    """Bytes a new allocation can take on a CUDA device: the free memory
    torch.cuda.mem_get_info reports plus what torch's caching allocator
    holds unused. None off CUDA."""
    if device.type != "cuda":
        return None
    with profiling.span("lif.mem_probe"):
        free, _ = torch.cuda.mem_get_info(device)
        return (free + torch.cuda.memory_reserved(device)
                - torch.cuda.memory_allocated(device))


def _fused_pose_chunk(n_layers, out_h, out_w, pose_chunk, free_bytes):
    """The fused core's pose chunk: at most `pose_chunk` (None or 0: no
    bound), and at most what `free_bytes` holds at
    _FUSED_BYTES_PER_LAYER_PX for each of `n_layers` projector layers,
    output pixel and pose (at least 1). free_bytes None: pose_chunk."""
    if free_bytes is None:
        return pose_chunk
    per_pose = n_layers * out_h * out_w * _FUSED_BYTES_PER_LAYER_PX
    fit = max(1, free_bytes // per_pose)
    return min(pose_chunk, fit) if pose_chunk else fit


def _lateral_march(lay, plan, k_l, crop_y, c1, poses, refine):
    """One layer of a pose chunk on the lateral march, raw: (found,
    invz_star, rgba_star). lay: the layer dict cut to the chunk
    (_chunk_layer); c1: the chunk's (B, 3) host positions. On CUDA the
    kernel on the cached march pack, with the chunk's poses already on the
    device (`poses`, (B, 3)); on the CPU the plain march, pose by pose."""
    c1 = np.asarray(c1, np.float32)
    with profiling.span("lif.kernel.lateral"):
        if "march_prep" in lay:  # hoisted (CUDA): the cached pack
            return _cuda_march.march_translation_cuda(
                *lay["march_src"], lay["izmin_host"], lay["izmax_host"], c1,
                lay["focal_host"], lay["plane_invz"], plan, k_l,
                offset=(lay["doff"][0], 0.0), prepared=lay["march_prep"],
                refine=refine, rows=lay["march_rows"], poses=poses)
        return _sweep_march.march_translation_batch_plain(
            *_march_sources(lay, plan, crop_y), lay["izmin_host"],
            lay["izmax_host"], c1, lay["focal_host"], lay["plane_invz"],
            plan, k_l, refine=refine, offset=lay["doff"])


def _fused_marches(view, poses, sl, refine):
    """Each layer of one projector of a fused pose chunk on the lateral
    march (_lateral_march), front to back, as a list of
    fused_epilogue.FusedLayer with the chunk's device poses."""
    marched = []
    for lay, plan, k_l in zip(view.layers, view.plans, view.nums):
        found, invz, rgba = _lateral_march(_chunk_layer(lay, sl), plan, k_l,
                                           0, view.pos_b[sl], poses, refine)
        marched.append(_fused_epilogue.FusedLayer(
            found, invz, rgba, poses, plan, lay["focal_host"], lay["doff"],
            0))
    return marched


def _fused_fast_core(views, background, *, refine, feathering, to_srgb,
                     fuse_tol, pose_chunk, out_h, out_w):
    """The body of render_fused_fast_batch: hoists each projector's march
    source prep, allocates the (B, H, W, 4) output and uploads every
    projector's poses once, then renders balanced pose chunks into it,
    each through every projector's lateral marches (_fused_marches) and
    the fused epilogue (ops/cuda/fused_epilogue.py): each projector's LDI
    composite on the raw march outputs, the tolerance-blended
    nearest-surface merge, the background and sRGB, in lif_tpu's order of
    operations; one kernel launch a chunk on the card, its plain version,
    the PyTorch chain, on the CPU, either counted once a chunk as
    epilogue.fused.merge. A chunk never exceeds pose_chunk nor, on CUDA,
    what the device's free memory holds (_fused_pose_chunk, from the
    shapes and the free memory after the output is allocated)."""
    views = [
        view._replace(layers=_attach_march_prep(
            view.layers, ["march"] * len(view.layers), view.plans,
            [0] * len(view.layers)))
        for view in views
    ]
    batch = len(views[0].pos_b)
    device = views[0].layers[0]["disp"].device
    out = torch.empty((batch, out_h, out_w, 4), dtype=torch.float32,
                      device=device)
    chunk = _fused_pose_chunk(sum(len(view.layers) for view in views), out_h,
                              out_w, pose_chunk, _free_device_bytes(device))
    poses = _cuda_march.upload_poses(
        np.stack([view.pos_b for view in views]), device)
    for sl in _pose_chunks(batch, chunk):
        with profiling.span("lif.chunk"):
            marched = [(view.mask_mode,
                        _fused_marches(view, poses[v, sl], sl, refine))
                       for v, view in enumerate(views)]
            with profiling.span("lif.epilogue.fused"):
                profiling.count("epilogue.fused.merge")
                _fused_epilogue.fused_epilogue(
                    marched, out[sl], background=background,
                    feathering=feathering, fuse_tol=fuse_tol,
                    to_srgb=to_srgb)
            del marched
    return out


def render(projectors, camera: Camera, mode: RenderMode = "raycast",
           **kwargs):
    """Render-mode dispatch (the HoloRenderer.onBeforeRender analog,
    reference HoloRenderer.ts:139-204), on the first projector:
      * 'raycast': the per-pixel inverse-depth march;
      * 'mesh': connected-triangle rasterization of the (W+1)x(H+1)
        corner grid (ops.mesh; the reference's default mesh mode,
        holoVertex.glsl meshMode=1 + HoloRenderer.ts:809-858);
      * 'billboard': the per-pixel square-footprint splat (ops.splat; the
        reference's billboard mode, holoVertex.glsl meshMode=0);
      * 'fast': the production single-view path, render_fast_view;
      * 'stereo': the first two projectors blended by the exact march,
        render_stereo_view;
      * 'stereo_fast': the same on the march tiers, render_stereo_fast."""
    plist = list(projectors) if isinstance(projectors, (list, tuple)) else [projectors]
    if mode == "raycast":
        return render_mono_view(plist[0], camera, **kwargs)
    if mode == "fast":
        return render_fast_view(plist[0], camera, **kwargs)
    if mode == "mesh":
        return _mesh.render_mesh_connected_view(plist[0], camera, **kwargs)
    if mode == "billboard":
        return _splat.render_mesh_view(plist[0], camera, **kwargs)
    if mode in ("stereo", "stereo_fast"):
        if len(plist) < 2:
            raise ValueError(f"{mode} mode needs two projectors")
        fn = render_stereo_view if mode == "stereo" else render_stereo_fast
        return fn(plist[0], plist[1], camera, **kwargs)
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
    poses = _read_poses(projector, cameras)
    if not poses.lateral:
        raise ValueError(
            "render_billboard_fast_batch needs lateral poses; use "
            "render(mode='billboard') per frame otherwise"
        )
    pos_b = poses.pos_b
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


@profiling.entry
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
    with profiling.span("lif.plan"):
        bp = plan_billboard(projector, cameras, point_size)
    lay = bp.layer
    return _splat_march.render_billboard_batch(
        lay["rgb"], lay["disp"], lay["mask"], lay["izmin_host"],
        lay["izmax_host"], bp.c1x, lay["focal_host"], bp.ixs, bp.mms,
        background, bp.plan, bp.num_planes, cx0=bp.cx0, cy0=bp.cy0,
        point_size=point_size, to_srgb=to_srgb, show_depth=show_depth,
    )
