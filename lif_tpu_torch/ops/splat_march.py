"""The billboard splat of a lateral pose batch: a row z-buffer scatter,
equal to a gather over a ladder.

The counterpart of lif_tpu.ops.pallas.splat_march. On lateral poses
(translation along x only, matched focal, centered principal point) the
billboard scatter of ops.splat.forward_splat has an exact gather dual:
source pixel p lands at u = p + 0.5 + delta(p), delta = f1 * cx * invz(p),
rows stay put, and while the footprint su < 2 the y footprint never leaves
the row. So target pixel o is covered by p = o - m exactly for the integer
shifts m with |m - delta(o - m)| <= su(o - m) / 2, and each target pixel
walks the integer-parallax ladder near -> far: the first covered plane
wins, then plane after plane takes over while its candidate is strictly
nearer (or as near with the lower source id), which is the scatter's
z-test and id resolve. The colour is the winner's point texel.

Here: the ladder (billboard_shift_tables, lif_tpu's numpy copied, plus an
assert that no real shift is clipped), the per-pose scalars in float32 as
lif_tpu bakes them, two plain versions of the same function — the dual
twin billboard_march_plain (one full-frame step per plane: the algorithm
of lif_tpu's TPU kernel, the oracle the CPU tests hold against it) and
billboard_scatter_plain (the z-buffer scatter of the CUDA kernel,
O(H·W) a pose) — the epilogue, and the dispatch render_billboard_batch: a
CUDA tensor launches the hand-written kernel csrc/splat_march.cu once for
the batch, a CPU tensor takes billboard_scatter_plain pose by pose.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.color import linear_to_srgb
from ..utils import profiling
from .cuda.splat_march import check_su_half, sweep_billboard
from .sweep_march import TranslationPlan

__all__ = [
    "billboard_inputs",
    "billboard_march_batch",
    "billboard_march_plain",
    "billboard_pose_scalars",
    "billboard_scatter_plain",
    "billboard_shift_tables",
    "finish_billboard",
    "render_billboard_batch",
    "su_half_bound",
]


def _round_up(n: int, q: int) -> int:
    return -(-n // q) * q


def billboard_shift_tables(f1: float, cxs, izmin: float, izmax: float,
                           plan: TranslationPlan):
    """Integer-shift ladder per pose, as lif_tpu builds it: every integer
    parallax the decode range can produce plus one on each side, near ->
    far, as window starts ix = pad_lo_x - m into the padded source, padded
    to one shared K (a multiple of 8) with sentinel shifts one beyond the
    far end, clipped into [0, tab_span_x]. Returns (ixs (B, K) int32,
    m (B, K) float32, K).

    lif_tpu clips silently; here a REAL shift outside the plan's window
    raises ValueError (its clipped plane would test the wrong texel). Only
    sentinels may clip: a clipped sentinel repeats the far end's plane,
    which can neither win a pixel the far plane left nor upgrade one."""
    ms = []
    for cx in cxs:
        a = float(f1) * float(cx)
        lo, hi = sorted((a * izmin, a * izmax))
        ms.append(np.arange(int(np.floor(lo)), int(np.ceil(hi)) + 2))
    k = max(len(m) for m in ms)
    k = max(8, _round_up(k, 8))
    ix_all, m_all = [], []
    for m, cx in zip(ms, cxs):
        a = float(f1) * float(cx)
        # near -> far: descending invz, i.e. m descending when a > 0
        m = m[::-1] if a > 0 else m
        real = plan.pad_lo_x - m
        if real.min() < 0 or real.max() > plan.tab_span_x:
            raise ValueError(
                f"billboard shifts {int(m.min())}..{int(m.max())} at cx={cx} "
                f"leave the plan's window [0, {plan.tab_span_x}] around "
                f"pad {plan.pad_lo_x}: plan for a larger shift"
            )
        pad = k - len(m)
        sent = m[-1] + (1 if len(m) < 2 or m[-1] > m[0] else -1)
        m_full = np.concatenate([m, np.full(pad, sent)])
        ix = np.clip(plan.pad_lo_x - m_full, 0, plan.tab_span_x)
        ix_all.append(ix.astype(np.int32))
        m_all.append((plan.pad_lo_x - ix).astype(np.float32))
    return np.stack(ix_all), np.stack(m_all), k


def su_half_bound(point_size: float, w: int, h: int, f1: float) -> float:
    """The largest su / 2 over the image (at its widest corner), as lif_tpu
    computes it; the dual is exact only while this stays under 1."""
    corner = np.sqrt(((w + 1.0) / 2.0 / float(f1)) ** 2
                     + ((h + 1.0) / 2.0 / float(f1)) ** 2 + 1.0)
    return 0.5 * point_size * float(corner)


def billboard_pose_scalars(f1: float, c1x, izmin: float, izmax: float,
                           point_size: float, w: int, h: int) -> np.ndarray:
    """(B, 3) float32 [A, Bc, su_half_max] per pose: delta(t) = A * t + Bc
    for disparity texel t (A = f1*cx*(izmin - izmax), Bc = f1*cx*izmax),
    rounded in float32 exactly as lif_tpu's render_billboard_batch_pallas
    computes them."""
    a_pose = np.float32(f1) * np.asarray(c1x, np.float32)
    izmin, izmax = np.float32(izmin), np.float32(izmax)
    su = np.float32(su_half_bound(point_size, w, h, f1))
    return np.stack([a_pose * (izmin - izmax), a_pose * izmax,
                     np.full_like(a_pose, su)], axis=1).astype(np.float32)


def _host(x) -> np.ndarray:
    """A host numpy copy of a small table (numpy, list or tensor)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def billboard_march_plain(disp, rgbm, ixs, mms, abp, pad_lo_x: int,
                          cx0: float, cy0: float, inv_f: float,
                          half_ps: float):
    """The gather dual for ONE pose, the algorithm of lif_tpu's TPU kernel:
    a Python loop over the K ladder planes of full-frame ops.

    disp: (H, W) float32; rgbm: (H, W, 4) [r, g, b, mask]; ixs (K,) int
    window starts and mms (K,) float shifts from billboard_shift_tables;
    abp: this pose's [A, Bc, ...] (host arrays or tensors); cx0/cy0 the principal point, inv_f the
    float32 1/f1 and half_ps the float32 0.5 * point_size (host floats).
    Returns found (H, W) 1/0, tex (H, W) the winner's disparity texel (-1
    where none) and rgba (H, W, 4) its point texel (0 where none)."""
    dev = disp.device
    h, w = disp.shape
    ixs = [int(x) for x in _host(ixs)]
    mms = [float(x) for x in _host(mms).astype(np.float32)]
    a, bc = torch.as_tensor(_host(abp)[:2].astype(np.float32), device=dev)
    cols = torch.arange(w, device=dev)
    yv = ((torch.arange(h, device=dev, dtype=torch.float32) + 0.5) - cy0
          ) * inv_f
    yterm = (yv * yv)[:, None]
    kstar = torch.full((h, w), -1, dtype=torch.int64, device=dev)
    btex = torch.full((h, w), -1.0, dtype=torch.float32, device=dev)
    for k, (ix, m) in enumerate(zip(ixs, mms)):
        s = cols + (ix - pad_lo_x)  # the candidate's source column
        inb = (s >= 0) & (s <= w - 1)
        t = disp[:, s.clamp(0, w - 1)]
        delta = a * t + bc
        xv = ((s.to(torch.float32) + 0.5) - cx0) * inv_f
        su_half = torch.clamp(
            half_ps * torch.sqrt((xv * xv)[None, :] + yterm + 1.0), min=0.5)
        d = m - delta
        covered = (d * d <= su_half * su_half) & inb
        sel = (kstar < 0) & covered
        if k > 0:
            # the previous plane's fresh winner loses iff this candidate is
            # strictly nearer (larger texel) or ties with the lower source
            # id (the smaller window start)
            beats = (t > btex) | ((t == btex) & (ix < ixs[k - 1]))
            sel = sel | ((kstar == k - 1) & covered & beats)
        kstar = torch.where(sel, k, kstar)
        btex = torch.where(sel, t, btex)
    found = kstar >= 0
    ix_t = torch.as_tensor(ixs, device=dev)
    src = (cols + ix_t[kstar.clamp(min=0)] - pad_lo_x).clamp(0, w - 1)
    rows = torch.arange(h, device=dev)[:, None]
    rgba = torch.where(found[..., None], rgbm[rows, src], 0.0)
    return found.to(torch.float32), btex, rgba


_NO_KEY = (1 << 63) - 1  # the empty z-buffer entry: larger than any key


def _depth_key(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """int64 z-buffer keys of candidates with disparity texel t (float32)
    from source column s: a smaller key is nearer (larger t), then the
    lower source column. The float's order-preserving 32-bit map, inverted,
    sits above the column (the kernel's u64 key, shifted one bit lower so
    that it stays non-negative). -0.0 is +0.0 first: the dual finds them
    equal."""
    t = torch.where(t == 0.0, 0.0, t)
    bits = t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    order = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF,
                        bits | 0x80000000)
    return ((0xFFFFFFFF - order) << 31) | s


def billboard_scatter_plain(disp, rgbm, ixs, mms, abp, pad_lo_x: int,
                            cx0: float, cy0: float, inv_f: float,
                            half_ps: float):
    """The scatter kernel's plain version for ONE pose (the arguments of
    billboard_march_plain; the ladder enters only through its shift range
    [min mms, max mms], since ixs = pad_lo_x - mms): O(H·W) work.

    Each source pixel (i, s) tests the at most three integer shifts m
    around its parallax delta = A·t + Bc that lie in the ladder's range,
    with the dual's cover test (m - delta)^2 <= su_half^2 in the same float
    sequence, and each covered target (i, s + m) keeps the smallest
    _depth_key: the nearest candidate, the lower source column among
    equal texels. While su_half < 1 this is the dual's first covered
    plane and its chain of upgrades: two covering shifts two or more apart
    have deltas more than 2 - 2·su_half apart in ladder order, so the
    farther one is strictly farther. Returns found, tex, rgba as
    billboard_march_plain does."""
    dev = disp.device
    h, w = disp.shape
    m_host = _host(mms).astype(np.float32)
    m_lo, m_hi = int(m_host.min()), int(m_host.max())
    a, bc = torch.as_tensor(_host(abp)[:2].astype(np.float32), device=dev)
    t = disp.to(torch.float32)
    s = torch.arange(w, device=dev)
    xv = ((s.to(torch.float32) + 0.5) - cx0) * inv_f
    yv = ((torch.arange(h, device=dev, dtype=torch.float32) + 0.5) - cy0
          ) * inv_f
    su_half = torch.clamp(
        half_ps * torch.sqrt((xv * xv)[None, :] + (yv * yv)[:, None] + 1.0),
        min=0.5)
    delta = a * t + bc
    r = torch.round(delta)
    near = (r >= m_lo - 1) & (r <= m_hi + 1)  # False for NaN
    r = torch.where(near, r, 0.0).to(torch.int64)
    key = _depth_key(t, s.expand(h, w))
    rows = torch.arange(h, device=dev)[:, None] * w
    zbuf = torch.full((h * w,), _NO_KEY, dtype=torch.int64, device=dev)
    for c in (-1, 0, 1):
        m = r + c
        o = s + m
        d = m.to(torch.float32) - delta
        hit = (near & (m >= m_lo) & (m <= m_hi) & (o >= 0) & (o < w)
               & (d * d <= su_half * su_half))
        zbuf.scatter_reduce_(0, (rows + o.clamp(0, w - 1))[hit], key[hit],
                             "amin")
    zbuf = zbuf.reshape(h, w)
    found = zbuf != _NO_KEY
    src = torch.where(found, zbuf & 0x7FFFFFFF, 0)
    hit_rows = torch.arange(h, device=dev)[:, None]
    tex = torch.where(found, t[hit_rows, src], -1.0)
    rgba = torch.where(found[..., None], rgbm[hit_rows, src], 0.0)
    return found.to(torch.float32), tex, rgba


def finish_billboard(found, tex, rgba, background, to_srgb: bool,
                     show_depth: bool):
    """(B, H, W) found/tex and (B, H, W, 4) rgba -> (B, H, W, 4) images:
    the winner's colour (or its disparity as grey with show_depth) and
    alpha 1 on a hit, the background elsewhere (lif_tpu's epilogue)."""
    bg = torch.as_tensor(np.asarray(background, np.float32),
                         device=found.device)
    profiling.host_sync("sync.upload.background", found.device)
    hit = found > 0.0
    rgb = torch.stack([tex] * 3, dim=-1) if show_depth else rgba[..., :3]
    rgb = torch.where(hit[..., None], rgb, bg[:3] * bg[3])
    alpha = torch.where(hit, 1.0, bg[3])
    if to_srgb:
        rgb = linear_to_srgb(rgb)
    return torch.cat([rgb, alpha[..., None]], dim=-1)


def render_billboard_batch(
    rgb,
    disp,
    mask,
    invz_min: float,
    invz_max: float,
    c1x,
    f1: float,
    ixs,
    mms,
    background,
    plan: TranslationPlan,
    num_planes: int,
    cx0: float,
    cy0: float,
    point_size: float = 1.0,
    to_srgb: bool = True,
    show_depth: bool = False,
):
    """The billboard splat of a lateral pose batch, on the device of the
    textures: one kernel launch on CUDA, the plain twin pose by pose on
    the CPU. c1x: (B,) relative x positions; ixs/mms: (B, K) from
    billboard_shift_tables with K = num_planes; invz_min/invz_max the
    baseline-normalized range; cx0/cy0 the (centered, GL) principal point.
    Output semantics of ops.splat.forward_splat (footprint 2, matched
    focal): the z-buffered nearest point texel, alpha 1 on a hit,
    background elsewhere. Returns (B, H, W, 4)."""
    with profiling.span("lif.kernel.billboard"):
        with profiling.span("lif.inputs"):
            inputs = billboard_inputs(rgb, disp, mask, invz_min, invz_max,
                                      c1x, f1, ixs, mms, plan, num_planes,
                                      cx0, cy0, point_size)
        found, tex, rgba = billboard_march_batch(*inputs)
    with profiling.span("lif.epilogue.billboard"):
        return finish_billboard(found, tex, rgba, background, to_srgb,
                                show_depth)


def billboard_inputs(rgb, disp, mask, invz_min, invz_max, c1x, f1, ixs, mms,
                     plan: TranslationPlan, num_planes: int, cx0: float,
                     cy0: float, point_size: float):
    """The kernel's inputs on the device of `disp`: disp (H, W), the
    (H, W, 4) [r, g, b, mask] stack, ixs/mms (B, K), the (B, 3) pose
    scalars, then the host ints and float32 values (pad_lo_x, cx0, cy0,
    inv_f, half_ps) — the arguments of sweep_billboard, and per pose of
    billboard_march_plain."""
    h, w = disp.shape
    ixs, mms = np.asarray(ixs, np.int32), np.asarray(mms, np.float32)
    if ixs.shape != mms.shape or ixs.shape[1] != num_planes:
        raise ValueError(f"ladders {ixs.shape}/{mms.shape}, expected "
                         f"K = {num_planes}")
    if (plan.src_w, plan.src_h) != (w, h):
        raise ValueError(f"plan {plan} for a {w}x{h} source")
    dev = disp.device
    abp = billboard_pose_scalars(f1, c1x, invz_min, invz_max, point_size, w,
                                 h)
    rgbm = torch.cat([rgb.to(torch.float32),
                      mask.to(torch.float32)[..., None]], dim=-1)
    profiling.host_sync("sync.upload.grids", dev, 2)
    profiling.host_sync("sync.upload.poses", dev)
    return (
        disp.to(torch.float32).contiguous(), rgbm.contiguous(),
        torch.as_tensor(ixs, device=dev), torch.as_tensor(mms, device=dev),
        torch.as_tensor(abp, device=dev), plan.pad_lo_x,
        float(np.float32(cx0)), float(np.float32(cy0)),
        float(np.float32(1.0 / float(f1))), float(np.float32(0.5 * point_size)),
    )


def billboard_march_batch(disp, rgbm, ixs, mms, abp, *geo):
    """The pose batch on the device of `disp`: a CUDA tensor launches the
    kernel once, a CPU tensor takes its plain version pose by pose. Both
    need su_half < 1 (ValueError otherwise). Returns found, tex (B, H, W)
    and rgba (B, H, W, 4)."""
    if disp.device.type == "cuda":
        return sweep_billboard(disp, rgbm, ixs, mms, abp, *geo)
    if disp.device.type != "cpu":
        raise NotImplementedError(
            f"the billboard splat runs on CUDA or CPU tensors, not "
            f"{disp.device.type}"
        )
    inv_f, half_ps = geo[3], geo[4]
    check_su_half(half_ps, disp.shape[1], disp.shape[0], inv_f)
    outs = [billboard_scatter_plain(disp, rgbm, ix, m, ab, *geo)
            for ix, m, ab in zip(ixs, mms, abp)]
    return tuple(torch.stack(parts) for parts in zip(*outs))
