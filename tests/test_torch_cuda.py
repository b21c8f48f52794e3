"""The CUDA kernels against their plain PyTorch versions, on the card
(marker `cuda`; every test skips where torch sees no CUDA device).

This file imports neither jax nor lif_tpu, so it also runs on a GPU host
without them: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py``. The lateral kernel must reproduce the plain
march bit for bit in `found` and to 3e-5 in invz*/rgba* (the
kernel-vs-twin gate of tests/test_sweep_march.py): its arithmetic is the
twin's, step by step, so only the plane-range bounds could differ — and
they are exact; since its redesign it is held bit for bit to the plain
march and the plain mirror of its skip walk, at refine 0, 1 and 2, on
scenes where the skips fire. The target-ray and scaled kernels are held
to the kernel-vs-twin gates of tests/test_sweep_target.py and
tests/test_sweep_scaled.py, and bit for bit to their plain marches and
the plain mirrors of their skip walks on scenes where the skips fire. The
billboard kernel and the plain-torch mesh modes are held to the
billboard's bound (tests/test_splat_march.py:106-115): hit disagreement,
and colour mismatches > 1e-6 where both hit, each under 1e-3 of the
pixels; the billboard kernel also bit for bit to both of its plain
versions (the scatter's and the ladder dual's), whose float sequence it
evaluates.
"""

import dataclasses

import numpy as np
import pytest
import torch

import lif_tpu_torch
from lif_tpu_torch.models import renderer as trenderer
from lif_tpu_torch.ops import splat_march as tbb
from lif_tpu_torch.ops import sweep_march as tsm
from lif_tpu_torch.ops import sweep_scaled as tss
from lif_tpu_torch.ops import sweep_target as tst
from lif_tpu_torch.ops.cuda import posed_epilogue as tpe
from lif_tpu_torch.ops.cuda import splat_march as tcuda_b
from lif_tpu_torch.ops.cuda import sweep_march as tcuda
from lif_tpu_torch.ops.cuda import sweep_scaled as tcuda_s
from lif_tpu_torch.ops.cuda import sweep_target as tcuda_t

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _scene(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = 0.5 + 0.3 * np.sin(xx / 17) * np.cos(yy / 13)
    disp[h // 3 : h // 2, w // 4 : w // 2] = 0.95
    disp = np.clip(disp + 0.05 * rng.random((h, w)), 0.0, 1.0)
    rgb = rng.random((h, w, 3), dtype=np.float32)
    mask = (rng.random((h, w)) > 0.2).astype(np.float32)
    return rgb, disp.astype(np.float32), mask


@pytest.mark.parametrize("w,h,snap", [(128, 160, True), (120, 96, False),
                                      (96, 200, True)])
def test_kernel_matches_plain_march(cuda, w, h, snap):
    """found equal, invz*/rgba* within 3e-5, at band widths 128, 8 and 32,
    one and two row chunks, snap grids and dense fractional grids."""
    rgb, disp, mask = _scene(w + h, h, w)
    f1, izmin, izmax = 0.78 * w, 2.0, 0.1
    cxs = [0.01, -0.035, 0.06]
    c1 = np.stack([np.asarray(cxs, np.float32), np.zeros(3, np.float32),
                   np.zeros(3, np.float32)], -1)
    if snap:
        planes, k = tsm.snap_plane_tables_batch(f1, cxs, izmin, izmax)
    else:
        k = 48
        planes = np.broadcast_to(
            (izmax + (izmin - izmax) * np.linspace(0.999, 0.001, k)
             ).astype(np.float32), (3, k)).copy()
    plan = tsm.translation_plan(w, h, w, h, f1 * 0.06 * izmin, 0.0)
    tex = [torch.from_numpy(a).to(cuda) for a in (rgb, disp, mask)]
    before = tcuda.sweep_lateral.launches
    found, invz, rgba = tcuda.march_translation_cuda(
        *tex, izmin, izmax, c1, f1, torch.from_numpy(planes), plan, k,
        rows=tsm.row_skip_tables(tex[1], izmin, izmax)[1:],
    )
    torch.cuda.synchronize()
    assert tcuda.sweep_lateral.launches == before + 1
    for i in range(3):
        f_p, iz_p, c_p = tsm.march_translation_plain(
            *tex, izmin, izmax, c1[i], f1, planes[i], plan, k
        )
        assert torch.equal(found[i], f_p)
        assert (invz[i] - iz_p).abs().max().item() < 3e-5
        assert (rgba[i] - c_p).abs().max().item() < 3e-5
    assert found.mean().item() > 0.5


def test_fast_batch_on_cuda_matches_cpu(cuda):
    """The slice on the card (two LDI layers, an odd width, pose chunks
    of 2) equals the same call on CPU tensors (the plain twin)."""
    h, w = 64, 127
    rgb0, disp0, mask0 = _scene(1, h, w)
    rgb1, disp1, _ = _scene(2, h + 16, w + 32)
    proj = lif_tpu_torch.projector_from_arrays(
        rgb0, disp0, mask0, focal_px=0.78 * w, invz_min=2.0, invz_max=0.6,
        baseline=1.0, device="cpu",
        extra_layers=[dict(rgb=rgb1, disp=disp1, focal_px=0.78 * w,
                           invz_min=0.5, invz_max=0.1)],
    )
    cams = [lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                        position=[x, 0.0, 0.0])
            for x in (0.02, 0.04, 0.06)]
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=2)
    before = tcuda.sweep_lateral.launches
    got = lif_tpu_torch.render_fast_batch(proj.to(cuda), cams, config=cfg)
    assert got.device.type == "cuda"
    # two layers x two pose chunks
    assert tcuda.sweep_lateral.launches == before + 4
    ref = lif_tpu_torch.render_fast_batch(proj, cams, config=cfg)
    assert (got.cpu() - ref).abs().max().item() < 1e-4


def _roty(deg):
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def _rotx(deg):
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float64)


@pytest.mark.parametrize("mode,refine,step_px", [
    ("depth", 0, 1.0), ("depth", 2, 3.0), ("color", 0, 1.0),
    ("color", 1, 2.0),
])
def test_target_kernel_matches_plain_march(cuda, mode, refine, step_px):
    """The target-ray kernel against march_target_plain on the card, to
    the kernel-vs-twin gate of tests/test_sweep_target.py (:149-153,
    :180-186): found flips < 0.1%, median |dinvz*| < 1e-5 and < 0.1% of
    pixels beyond 1e-3 (the kernel evaluates the twin's float sequence,
    so it should be exact)."""
    h, w = 112, 128
    rgb, disp, mask = _scene(7, h, w)
    f1, izmin, izmax = 0.78 * w, 2.0, 0.1
    rots = [_roty(12.0), _roty(-8.0), _roty(0.5)]
    cs = [np.array(c) for c in ([0.22, 0.0, -0.03], [-0.12, 0.05, 0.02],
                                [0.0, 0.0, 0.0])]
    plan, _, _ = tst.plan_target(w, h, w, h, f1, f1, rots, cs, izmin, izmax)
    grids, k = tst.target_plane_grids(rots, cs, f1, f1, w, h, w, h, izmin,
                                      izmax, step_px=step_px)
    poses = np.stack([tst.target_pose_scalars(r, c, f1, f1, w, h, w, h)
                      for r, c in zip(rots, cs)])
    tex = [torch.from_numpy(a).to(cuda) for a in (rgb, disp, mask)]
    rgbm = tst._rgbm_stack(tex[0], tex[2]) if mode == "color" else None
    before = tcuda_t.sweep_target.launches
    out = tcuda_t.march_target_cuda(
        tex[1], izmin, izmax, torch.from_numpy(poses).to(cuda),
        torch.from_numpy(grids).to(cuda), plan, refine=refine, rgbm=rgbm,
        tables=tcuda_t.skip_table_buffer(tex[1]))
    torch.cuda.synchronize()
    assert tcuda_t.sweep_target.launches == before + 1
    for i in range(3):
        ref = tst.march_target_plain(tex[1], izmin, izmax, poses[i],
                                     grids[i], w, h, refine=refine,
                                     rgbm=rgbm)
        f_k, f_p = out[0][i], ref[0]
        assert (f_k != f_p).float().mean().item() < 1e-3
        for got, want in zip(out[1:], ref[1:]):
            err = ((got[i] - want).abs() * (f_k == f_p).reshape(
                f_k.shape + (1,) * (want.ndim - 2))).cpu().numpy()
            assert np.median(err) < 1e-5
            assert (err > 1e-3).mean() < 1e-3
    assert out[0].mean().item() > 0.5


def _far_scene(h, w):
    """A far background (disparity 0.04..0.17, a ramp) behind a near box:
    the walk from the box's planes to the background's crossings passes
    long runs of planes no texel near a warp can reach."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = 0.04 + 0.12 * xx / w + 0.01 * np.sin(yy / 7)
    disp[h // 3 : h // 2, w // 4 : w // 2] = 0.95
    rng = np.random.default_rng(h + w)
    rgb = rng.random((h, w, 3), dtype=np.float32)
    mask = (rng.random((h, w)) > 0.2).astype(np.float32)
    return rgb, disp.astype(np.float32), mask


def _run_edge_scene(h, w, pose, grid, izmin, izmax):
    """A flat background behind a near box, its disparity halfway between
    the thresholds of the first plane of a skip run (counted from the
    pose's start plane, as the kernel counts them) and the plane before:
    the background crosses right after a run its warps skip whole."""
    rgb, disp, mask = _far_scene(h, w)
    box = disp == np.float32(0.95)
    stats = {}
    tst.march_target_skip_plain(torch.from_numpy(disp), izmin, izmax, pose,
                                grid, w, h, stats=stats)
    tk = tst.plane_thresholds(torch.from_numpy(grid), izmin, izmax).numpy()
    starts = np.arange(stats["k_start"] + tst.SKIP_RUN, len(grid),
                       tst.SKIP_RUN)
    c = starts[np.argmin(np.abs(tk[starts] - 0.3))]
    disp[~box] = (tk[c - 1] + tk[c]) / 2
    return rgb, disp, mask


@pytest.mark.parametrize("scene", ["far", "run_edge"])
@pytest.mark.parametrize("mode,refine", [("depth", 0), ("depth", 1),
                                         ("color", 0)])
def test_target_kernel_exact_through_skipped_runs(cuda, scene, mode, refine):
    """On a far background the warps skip long runs of planes (most runs of
    pose 0); on a flat one whose crossing is the first plane of a run, the
    crossings fall right after a run skipped whole, so the secant bracket
    is read afresh there. The kernel still equals march_target_plain bit
    for bit, as its plain mirror march_target_skip_plain does."""
    h, w = 112, 128
    f1, izmin, izmax = 0.78 * w, 2.0, 0.1
    rots = [_roty(12.0), _roty(-8.0), _roty(3.0)]
    cs = [np.array(c) for c in ([0.22, 0.0, -0.03], [-0.12, 0.05, 0.02],
                                [0.05, 0.0, 0.0])]
    plan, _, _ = tst.plan_target(w, h, w, h, f1, f1, rots, cs, izmin, izmax)
    grids, k = tst.target_plane_grids(rots, cs, f1, f1, w, h, w, h, izmin,
                                      izmax)
    poses = np.stack([tst.target_pose_scalars(r, c, f1, f1, w, h, w, h)
                      for r, c in zip(rots, cs)])
    if scene == "far":
        rgb, disp, mask = _far_scene(h, w)
    else:
        rgb, disp, mask = _run_edge_scene(h, w, poses[0], grids[0], izmin,
                                          izmax)
    tex = [torch.from_numpy(a).to(cuda) for a in (rgb, disp, mask)]
    rgbm = tst._rgbm_stack(tex[0], tex[2]) if mode == "color" else None
    out = tcuda_t.march_target_cuda(
        tex[1], izmin, izmax, torch.from_numpy(poses).to(cuda),
        torch.from_numpy(grids).to(cuda), plan, refine=refine, rgbm=rgbm,
        tables=tcuda_t.skip_table_buffer(tex[1]))
    torch.cuda.synchronize()
    stats = [{} for _ in range(3)]
    for i in range(3):
        ref = tst.march_target_plain(tex[1], izmin, izmax, poses[i],
                                     grids[i], w, h, refine=refine,
                                     rgbm=rgbm)
        mirror = tst.march_target_skip_plain(
            tex[1], izmin, izmax, poses[i], grids[i], w, h, refine=refine,
            rgbm=rgbm, stats=stats[i])
        for got, want, mir in zip(out, ref, mirror):
            assert torch.equal(got[i], want) and torch.equal(mir, want)
    assert stats[0]["runs_skipped"] > stats[0]["runs"] // 2
    if scene == "run_edge":
        assert stats[0]["after_skip"] > h * w // 4
    assert out[0].mean().item() > 0.5


def test_target_kernel_rejects_bad_inputs(cuda):
    """The wrapper refuses CPU tensors, ladders beyond 1024 planes and a
    launch without the skip tables."""
    disp = torch.rand(16, 16, device=cuda)
    pose = torch.zeros(1, 16, device=cuda)
    vg = torch.zeros(1, 1100, device=cuda)
    tables = tcuda_t.skip_table_buffer(disp)
    with pytest.raises(ValueError, match="1024"):
        tcuda_t.sweep_target(disp, pose, vg, vg.clone(), disp.amax()[None],
                             16, 16, tables=tables)
    with pytest.raises(ValueError, match="CUDA"):
        tcuda_t.sweep_target(disp.cpu(), pose, vg[:, :8], vg[:, :8],
                             disp.amax()[None], 16, 16, tables=tables)
    with pytest.raises(ValueError, match="tables is required"):
        tcuda_t.sweep_target(disp, pose, vg[:, :8], vg[:, :8],
                             disp.amax()[None], 16, 16, tables=None)


def test_orbit_fast_batch_on_cuda_matches_cpu(cuda):
    """The orbit path on the card: a two-layer LDI yaw orbit (pose chunks
    of 2: two layers x two chunks = 4 launches) and a pitch batch through
    the transposed route, against the same calls on CPU tensors."""
    h, w = 112, 128
    rgb0, disp0, mask0 = _scene(4, h, w)
    rgb1, disp1, _ = _scene(5, h + 16, w + 32)
    proj = lif_tpu_torch.projector_from_arrays(
        rgb0, disp0, mask0, focal_px=0.78 * w, invz_min=2.0, invz_max=0.6,
        baseline=1.0, device="cpu",
        extra_layers=[dict(rgb=rgb1, disp=disp1, focal_px=0.78 * w,
                           invz_min=0.5, invz_max=0.1)],
    )
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=2)
    for poses, launches in (
        ([(_roty(-6.0), [-0.1, 0.0, 0.01]), (_roty(2.0), [0.03, 0.0, 0.0]),
          (_roty(8.0), [0.15, 0.0, -0.01])], 4),
        ([(_rotx(6.0), [0.1, 0.0, 0.0]), (_rotx(-4.0), [0.0, 0.05, 0.0])], 2),
    ):
        cams = [lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                            position=c, rotation=r)
                for r, c in poses]
        before = tcuda_t.sweep_target.launches
        got, tiers = lif_tpu_torch.render_fast_batch(
            proj.to(cuda), cams, config=cfg, return_tiers=True)
        torch.cuda.synchronize()
        assert tiers == ("target", "target")
        assert got.device.type == "cuda"
        assert tcuda_t.sweep_target.launches == before + launches
        ref = lif_tpu_torch.render_fast_batch(proj, cams, config=cfg)
        err = (got.cpu() - ref).abs().amax(-1)
        assert (err > 1e-3).float().mean().item() < 1e-3
        assert err.median().item() < 1e-5


def _scaled_inputs(seed, c1s, h=96, w=128, fr=1.0, plan_c1=None, lo=0.0,
                   hi=1.0, step_px=1.0):
    """A seeded scene (disparity scaled into [lo, hi]), its scaled plan
    over the pose bounds of `plan_c1` (default: the poses) and per-pose
    ladders."""
    rgb, disp, mask = _scene(seed, h, w)
    disp = (lo + (hi - lo) * disp).astype(np.float32)
    f1, izmin, izmax = 0.78 * w, 2.0, 0.1
    c1s = np.asarray(c1s, np.float64)
    pc = c1s if plan_c1 is None else np.asarray(plan_c1, np.float64)
    plan = tss.scaled_plan(
        w, h, w, h, f1, fr, float(np.abs(pc[:, 0]).max()),
        float(np.abs(pc[:, 1]).max()), float(min(pc[:, 2].min(), 0.0)),
        float(max(pc[:, 2].max(), 0.0)), izmin, izmax)
    grids, k = tss.parallax_step_grids_batch(f1, c1s, fr, w, h, izmin, izmax,
                                             step_px=step_px)
    return rgb, disp, mask, f1, izmin, izmax, plan, grids, k


_SCALED_C1 = [[0.03, 0.0, 0.04], [0.04, 0.02, 0.0], [0.02, 0.01, 0.03]]


def _scaled_vs_plain(cuda, inputs, c1s, refine, color, fr=1.0):
    rgb, disp, mask, f1, izmin, izmax, plan, grids, k = inputs
    tex = [torch.from_numpy(a).to(cuda) for a in (rgb, disp, mask)]
    tabs = tss.scaled_table_stack(plan, torch.from_numpy(grids).to(cuda),
                                  torch.as_tensor(np.asarray(c1s, np.float32),
                                                  device=cuda), f1, fr)
    rgbm = tst._rgbm_stack(tex[0], tex[2]) if color else None
    before = tcuda_s.sweep_scaled.launches
    out = tcuda_s.march_scaled_cuda(
        tex[1], izmin, izmax, tabs, plan, refine=refine, rgbm=rgbm,
        skip_tables=tss.skip_pack(tex[1], izmin, izmax))
    torch.cuda.synchronize()
    assert tcuda_s.sweep_scaled.launches == before + 1
    err = 0.0
    for i in range(len(c1s)):
        ref = tss.march_scaled_plain(tex[1], izmin, izmax, tabs[i], plan,
                                     refine=refine, rgbm=rgbm)
        assert torch.equal(out[0][i], ref[0])
        for got, want in zip(out[1:], ref[1:]):
            err = max(err, (got[i] - want).abs().max().item())
    assert err < 1e-4
    return out


@pytest.mark.parametrize("refine,color", [(0, False), (1, False), (2, False),
                                          (0, True), (2, True)])
def test_scaled_kernel_matches_plain_march(cuda, refine, color):
    """The scaled kernel against march_scaled_plain on the card: found
    equal and max abs < 1e-4 (the kernel evaluates the twin's float
    sequence, so it should be exact), depth only at refine 0/1/2 and
    full color."""
    inputs = _scaled_inputs(11, _SCALED_C1)
    out = _scaled_vs_plain(cuda, inputs, _SCALED_C1, refine, color)
    assert out[0].mean().item() > 0.5


def test_scaled_kernel_start_skip_deep_in_the_ladder(cuda):
    """Disparity in [0.05, 0.35]: the first plane a texel can reach lies
    deep in the ladder, so the kernel starts there; the bracket must still
    equal the twin's (which walks from plane 0)."""
    inputs = _scaled_inputs(12, _SCALED_C1, lo=0.05, hi=0.35)
    _, _, _, _, izmin, izmax, _, grids, _ = inputs
    first = int(np.argmax(grids[0] <= izmax + 0.35 * (izmin - izmax)))
    assert first > grids.shape[1] // 2
    for refine in (0, 2):
        _scaled_vs_plain(cuda, inputs, _SCALED_C1, refine, True)


def test_scaled_kernel_saturated_clip_and_odd_block(cuda):
    """A plan made for small poses, used at larger ones, saturates the
    displacement clip at the plan's pad borders; widths 120 and 72 are not
    multiples of the 32-column block; zoom fr = 1.08."""
    c1s = [[0.2, 0.1, 0.05], [-0.15, -0.08, -0.04]]
    inputs = _scaled_inputs(13, c1s, plan_c1=[[0.01, 0.005, 0.0]])
    _scaled_vs_plain(cuda, inputs, c1s, 2, True)
    for w in (120, 72):
        inputs = _scaled_inputs(14, _SCALED_C1, w=w, h=56, fr=1.08)
        _scaled_vs_plain(cuda, inputs, _SCALED_C1, 2, True, fr=1.08)


def _scaled_exact(cuda, inputs, c1s, refine, color, fr=1.0):
    """The scaled kernel against march_scaled_plain and its skip mirror
    march_scaled_skip_plain, bit for bit; returns the mirror's counts."""
    rgb, disp, mask, f1, izmin, izmax, plan, grids, k = inputs
    tex = [torch.from_numpy(a).to(cuda) for a in (rgb, disp, mask)]
    tabs = tss.scaled_table_stack(plan, torch.from_numpy(grids).to(cuda),
                                  torch.as_tensor(np.asarray(c1s, np.float32),
                                                  device=cuda), f1, fr)
    rgbm = tst._rgbm_stack(tex[0], tex[2]) if color else None
    tables, dlim = tss.skip_pack(tex[1], izmin, izmax)
    out = tcuda_s.sweep_scaled(tex[1], tabs, dlim, plan, izmin, izmax,
                               refine=refine, rgbm=rgbm, tables=tables)
    torch.cuda.synchronize()
    stats = {}
    for i in range(len(c1s)):
        want = tss.march_scaled_plain(tex[1], izmin, izmax, tabs[i], plan,
                                      refine=refine, rgbm=rgbm)
        mirror = tss.march_scaled_skip_plain(tex[1], izmin, izmax, tabs[i],
                                             plan, refine=refine, rgbm=rgbm,
                                             stats=stats)
        for got, ref, mir in zip(out, want, mirror):
            assert torch.equal(got[i], ref) and torch.equal(mir, ref)
    return stats


@pytest.mark.parametrize("scene", ["noise", "far", "down"])
@pytest.mark.parametrize("refine,color", [(0, False), (2, False), (0, True),
                                          (1, True)])
def test_scaled_kernel_exact_through_skipped_runs(cuda, scene, refine, color):
    """The scaled kernel equals march_scaled_plain bit for bit, as its
    plain mirror does, depth only at refine 0, 1 and 2 and in full color;
    on the far scene warps skip most runs; a range whose decode falls as
    the texel rises reads the tables of -disp."""
    c1s = _SCALED_C1
    if scene == "far":
        rgb, disp, mask = _far_scene(96, 128)
        inputs = list(_scaled_inputs(11, c1s))
        inputs[:3] = rgb, disp, mask
    elif scene == "down":
        inputs = list(_scaled_inputs(11, c1s))
        inputs[4:6] = 0.1, 2.0  # izmin < izmax, the ladder kept
    else:
        inputs = _scaled_inputs(11, c1s)
    stats = _scaled_exact(cuda, inputs, c1s, refine, color)
    if scene == "far":
        assert stats["runs_skipped"] > stats["runs"] // 4


def test_scaled_kernel_exact_on_a_phase_a_ladder(cuda):
    """Phase A of the two-phase rotated tier: the aligned positions and
    per-pose ladders of plan_rotated on a wider intermediate than the
    source, fr = 1, refine 2: exact against both plain versions."""
    from lif_tpu_torch.ops import rotated_march as trm

    h, w = 96, 128
    rgb, disp, mask = _scene(16, h, w)
    f1, izmin, izmax = 0.78 * w, 2.0, 0.1
    rots = [_rotx(2.0) @ _roty(t) for t in (-6.0, 0.0, 5.0)]
    cs = [np.array([0.05 * np.sin(np.deg2rad(t)), 0.0, 0.0])
          for t in (-6.0, 0.0, 5.0)]
    plan, wi, hi, aligned, grids, k, skip = trm.plan_rotated(
        w, h, w, h, f1, f1, rots, cs, izmin, izmax)
    assert not skip and (wi, hi) != (w, h)
    inputs = (rgb, disp, mask, f1, izmin, izmax, plan, grids, k)
    _scaled_exact(cuda, inputs, aligned, 2, False)


def test_scaled_kernel_batch_equals_per_pose(cuda):
    """Each pose of a batched launch equals the same pose launched alone."""
    rgb, disp, mask, f1, izmin, izmax, plan, grids, k = _scaled_inputs(
        15, _SCALED_C1)
    d = torch.from_numpy(disp).to(cuda)
    tabs = tss.scaled_table_stack(plan, torch.from_numpy(grids).to(cuda),
                                  torch.tensor(_SCALED_C1, device=cuda),
                                  f1, 1.0)
    pack = tss.skip_pack(d, izmin, izmax)
    whole = tcuda_s.march_scaled_cuda(d, izmin, izmax, tabs, plan, refine=2,
                                      skip_tables=pack)
    for i in range(len(_SCALED_C1)):
        one = tcuda_s.march_scaled_cuda(d, izmin, izmax, tabs[i : i + 1],
                                        plan, refine=2, skip_tables=pack)
        assert torch.equal(one[0][0], whole[0][i])
        assert torch.equal(one[1][0], whole[1][i])


@pytest.mark.parametrize("w", [128, 127])
def test_scaled_and_rotated_fast_batch_on_cuda_matches_cpu(cuda, w):
    """The scaled tier (a dolly) and the rotated tier (yaw + pitch) of a
    two-layer LDI on the card, pose chunks of 2 (two layers x two chunks
    = 4 launches of the scaled kernel), at width 128 and at 127 (the pad
    through dx_user on 'scaled', dropped on 'rotated'), against the same
    calls on CPU tensors."""
    h = 112
    rgb0, disp0, mask0 = _scene(6, h, w)
    rgb1, disp1, _ = _scene(8, h + 16, w + 32)
    proj = lif_tpu_torch.projector_from_arrays(
        rgb0, disp0, mask0, focal_px=0.78 * w, invz_min=2.0, invz_max=0.6,
        baseline=1.0, device="cpu",
        extra_layers=[dict(rgb=rgb1, disp=disp1, focal_px=0.78 * w,
                           invz_min=0.5, invz_max=0.1)],
    )
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=2)
    for poses, tier in (
        ([(np.eye(3), [0.03, 0.01, 0.02]), (np.eye(3), [-0.02, 0.02, -0.03]),
          (np.eye(3), [0.0, -0.01, 0.04])], "scaled"),
        ([(_rotx(3.0) @ _roty(4.0), [0.05, 0.01, 0.0]),
          (_rotx(-2.0) @ _roty(-3.0), [-0.04, 0.0, 0.01]),
          (_rotx(1.0) @ _roty(2.0), [0.0, 0.02, 0.0])], "rotated"),
    ):
        cams = [lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                            position=c, rotation=r)
                for r, c in poses]
        before = tcuda_s.sweep_scaled.launches
        got, tiers = lif_tpu_torch.render_fast_batch(
            proj.to(cuda), cams, config=cfg, return_tiers=True)
        torch.cuda.synchronize()
        assert tiers == (tier, tier)
        assert got.device.type == "cuda" and got.shape == (3, h, w, 4)
        assert tcuda_s.sweep_scaled.launches == before + 4
        ref = lif_tpu_torch.render_fast_batch(proj, cams, config=cfg)
        err = (got.cpu() - ref).abs().amax(-1)
        assert (err > 1e-3).float().mean().item() < 1e-3
        assert err.median().item() < 1e-5


def test_refine_raises_on_cuda(cuda):
    """The lateral kernel computes refine > 0 since its redesign (it used
    to raise here, which this test checked): render_fast_batch with
    refine 1 and 2 on the card equals the same call on CPU tensors (the
    plain twin), one kernel launch each."""
    rgb, disp, _ = _scene(3, 32, 64)
    proj = lif_tpu_torch.projector_from_arrays(
        rgb, disp, focal_px=0.78 * 64, invz_min=2.0, invz_max=0.1,
        baseline=1.0, device="cpu",
    )
    cams = [lif_tpu_torch.Camera.create(64, 32, focal_px=0.78 * 64,
                                        position=[x, 0.0, 0.0])
            for x in (0.03, -0.05)]
    for refine in (1, 2):
        before = tcuda.sweep_lateral.launches
        got, tiers = lif_tpu_torch.render_fast_batch(
            proj.to(cuda), cams, refine=refine, return_tiers=True)
        torch.cuda.synchronize()
        assert tiers == ("march",)
        assert tcuda.sweep_lateral.launches == before + 1
        ref = lif_tpu_torch.render_fast_batch(proj, cams, refine=refine)
        assert (got.cpu() - ref).abs().max().item() < 1e-5


def _lateral_scene(kind, h, w):
    """'noise': _scene's; 'far': a far background ramp behind a near box,
    whose warps skip long runs of planes; 'down': the same read through a
    decode that falls as the texel rises (the tables of -disp)."""
    if kind == "noise":
        return _scene(h * 3 + w, h, w)
    return _far_scene(h, w)


@pytest.mark.parametrize("kind", ["noise", "far", "down"])
@pytest.mark.parametrize("refine", [0, 1, 2])
@pytest.mark.parametrize("w,h,snap", [(128, 160, True), (120, 96, False),
                                      (97 + 31, 40, True)])
def test_lateral_kernel_exact_through_skipped_runs(cuda, kind, refine, w, h,
                                                   snap):
    """The lateral kernel equals march_translation_plain bit for bit
    (found, invz*, rgba*), and so does its plain mirror
    march_translation_skip_plain, at refine 0, 1 and 2, on snap and dense
    ladders, band widths 128 and 8, and through a decode that falls as the
    texel rises; on the far scene's dense ladder most warp runs are
    skipped."""
    rgb, disp, mask = _lateral_scene(kind, h, w)
    f1 = 0.78 * w
    izmin, izmax = (0.1, 2.0) if kind == "down" else (2.0, 0.1)
    cxs = [0.01, -0.035, 0.06]
    c1 = np.stack([np.asarray(cxs, np.float32), np.zeros(3, np.float32),
                   np.zeros(3, np.float32)], -1)
    if snap:
        planes, k = tsm.snap_plane_tables_batch(f1, cxs, max(izmin, izmax),
                                                min(izmin, izmax))
    else:
        k = 48
        planes = np.broadcast_to((0.1 + 1.9 * np.linspace(0.999, 0.001, k)
                                  ).astype(np.float32), (3, k)).copy()
    plan = tsm.translation_plan(w, h, w, h, f1 * 0.06 * 2.0, 0.0)
    tex = [torch.from_numpy(a).to(cuda) for a in (rgb, disp, mask)]
    prepared = tcuda.prepare_translation_src(*tex, plan)
    args = tcuda.lateral_kernel_inputs(prepared, izmin, izmax, c1, f1,
                                       torch.from_numpy(planes).to(cuda),
                                       plan, k)
    out = tcuda.sweep_lateral(
        *args, refine=refine,
        rows=tsm.row_skip_tables(prepared[0][4], izmin, izmax)[1:])
    torch.cuda.synchronize()
    stats = {}
    for i in range(3):
        want = tsm.march_translation_plain(*tex, izmin, izmax, c1[i], f1,
                                           planes[i], plan, k, refine=refine)
        mirror = tsm.march_translation_skip_plain(
            *tex, izmin, izmax, c1[i], f1, planes[i], plan, k, refine=refine,
            stats=stats)
        for got, ref, mir in zip(out, want, mirror):
            assert torch.equal(got[i], ref) and torch.equal(mir, ref)
    if kind == "far" and not snap:
        assert stats["runs_skipped"] > stats["runs"] // 4
    assert out[0].mean().item() > 0.3


def test_lateral_kernel_rejects_bad_inputs(cuda):
    """The wrapper refuses an empty ladder and a launch without the row
    skip tables (a ladder beyond one 1024-plane segment is walked in
    segments: test_lateral_kernel_exact_across_segments)."""
    rgb, disp, mask = _scene(9, 16, 64)
    plan = tsm.translation_plan(64, 16, 64, 16, 10.0, 0.0)
    tex = [torch.from_numpy(a).to(cuda) for a in (rgb, disp, mask)]
    src = tcuda.prepare_translation_src(*tex, plan)[0]
    rows = tsm.row_skip_tables(src[4], 2.0, 0.1)[1:]
    for k, r, match in ((0, rows, "at least one"),
                        (8, None, "rows is required")):
        ix = torch.zeros((1, k), dtype=torch.int32, device=cuda)
        fx = torch.zeros((1, k), device=cuda)
        klo = torch.zeros((1, 1, 1), dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match=match):
            tcuda.sweep_lateral(src, ix, fx, fx, klo, klo, 2.0, 0.1, plan,
                                rows=r)


@pytest.mark.parametrize("kind", ["noise", "far"])
@pytest.mark.parametrize("k,refine", [(256, 0), (256, 2), (1536, 0),
                                      (1536, 1)])
def test_lateral_kernel_exact_across_segments(cuda, kind, k, refine):
    """On a uniform ladder (renderer._plane_table), whose shifts fall
    between texels at nearly every plane (the lerp at fractional shifts,
    the warp-run skip over fractional ix / fx, the bracket refresh after a
    skipped fractional plane), the lateral kernel equals
    march_translation_plain bit for bit, and so does its skip mirror; at
    K = 1536 the walk crosses the kernel's 1024-plane segment."""
    assert (k > tcuda.SEGMENT_PLANES) == (k == 1536)
    h, w = 40, 128
    rgb, disp, mask = _lateral_scene(kind, h, w)
    f1, izmin, izmax = 0.78 * w, 2.0, 0.1
    cxs = [0.01, -0.035, 0.06]
    c1 = np.stack([np.asarray(cxs, np.float32), np.zeros(3, np.float32),
                   np.zeros(3, np.float32)], -1)
    planes = np.broadcast_to(trenderer._plane_table(
        disp, np.float32(izmin), np.float32(izmax), k, "uniform"),
        (3, k)).copy()
    plan = tsm.translation_plan(w, h, w, h, f1 * 0.06 * izmin, 0.0)
    tex = [torch.from_numpy(a).to(cuda) for a in (rgb, disp, mask)]
    prepared = tcuda.prepare_translation_src(*tex, plan)
    args = tcuda.lateral_kernel_inputs(prepared, izmin, izmax, c1, f1,
                                       torch.from_numpy(planes).to(cuda),
                                       plan, k)
    assert (args[2] != 0).float().mean().item() >= 0.9
    out = tcuda.sweep_lateral(
        *args, refine=refine,
        rows=tsm.row_skip_tables(prepared[0][4], izmin, izmax)[1:])
    torch.cuda.synchronize()
    for i in range(3):
        want = tsm.march_translation_plain(*tex, izmin, izmax, c1[i], f1,
                                           planes[i], plan, k, refine=refine)
        mirror = tsm.march_translation_skip_plain(
            *tex, izmin, izmax, c1[i], f1, planes[i], plan, k, refine=refine)
        for got, ref, mir in zip(out, want, mirror):
            assert torch.equal(got[i], ref) and torch.equal(mir, ref)
    assert out[0].mean().item() > 0.3


@pytest.mark.parametrize("mode,k", [("uniform", 256), ("hybrid", 256),
                                    ("uniform", 1536)])
def test_plane_modes_on_cuda_match_cpu(cuda, mode, k):
    """render_fast_batch, render_stereo_fast_batch and
    render_fused_fast_batch on the uniform and hybrid grids on the card
    (one lateral launch per layer and pose chunk, the (K,) table expanded
    per pose across chunks of 2) agree with the same calls on CPU tensors:
    mono within 1e-4, stereo and fusion at most 0.1% of the pixels off by
    more than 1e-3 (the gates of the card tests above)."""
    h, w = 64, 128
    rgb0, disp0, mask0 = _scene(11, h, w)
    rgb1, disp1, _ = _scene(12, h + 16, w + 32)
    proj = lif_tpu_torch.projector_from_arrays(
        rgb0, disp0, mask0, focal_px=0.78 * w, invz_min=2.0, invz_max=0.6,
        baseline=1.0, device="cpu",
        extra_layers=[dict(rgb=rgb1, disp=disp1, focal_px=0.78 * w,
                           invz_min=0.5, invz_max=0.1)],
    )
    cams = [lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                        position=[x, 0.0, 0.0])
            for x in (0.02, 0.04, 0.06)]
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(plane_mode=mode,
                                               march_planes=k, pose_chunk=2)
    # fusion takes layers of the camera's dims: the base layer alone
    flat = lif_tpu_torch.projector_from_arrays(
        rgb0, disp0, mask0, focal_px=0.78 * w, invz_min=2.0, invz_max=0.6,
        baseline=1.0, device="cpu")

    def pair(p):
        return p, dataclasses.replace(
            p, position=np.asarray(p.position) + [0.05, 0.0, 0.0])

    calls = (
        (lambda p, r: lif_tpu_torch.render_fast_batch(p, cams, config=cfg),
         proj, 4),
        (lambda p, r: lif_tpu_torch.render_stereo_fast_batch(
            p, r, cams, config=cfg), proj, 8),
        (lambda p, r: lif_tpu_torch.render_fused_fast_batch(
            [p, r], cams, config=cfg), flat, 4),
    )
    for n, (fn, base, launches) in enumerate(calls):
        before = tcuda.sweep_lateral.launches
        got = fn(*pair(base.to(cuda)))
        torch.cuda.synchronize()
        assert tcuda.sweep_lateral.launches == before + launches
        err = (got.cpu() - fn(*pair(base))).abs().amax(-1)
        if n == 0:
            assert err.max().item() < 1e-4
        else:  # the stereo and fused gates of the card tests above
            assert (err > 1e-3).float().mean().item() <= 1e-3


def test_texture_cache_holds_skip_tables_on_cuda(cuda):
    """A CUDA layer of the texture cache carries each march kernel's skip
    tables, equal to that kernel's builder on the layer's disparity, and
    an in-place write to the disparity rebuilds them."""
    from lif_tpu_torch.models import renderer as trenderer

    rgb, disp, mask = _scene(23, 48, 64)
    proj = lif_tpu_torch.projector_from_arrays(
        rgb, disp, mask, focal_px=0.78 * 64, invz_min=2.0, invz_max=0.1,
        baseline=1.0, device=cuda)
    for scale in (1.0, 0.5):
        proj.disp.mul_(scale)
        lay = trenderer._prepared_textures(proj)[0]
        d, izmin, izmax = lay["disp"], lay["izmin_host"], lay["izmax_host"]
        assert torch.equal(lay["skip_target"], tcuda_t.skip_table_buffer(d))
        for got, want in zip(lay["skip_scaled"],
                             tss.skip_pack(d, izmin, izmax)):
            assert torch.equal(got, want)
        for got, want in zip(lay["skip_rows"],
                             tsm.row_skip_tables(d, izmin, izmax)[1:]):
            assert torch.equal(got, want)


def _bb_disagreement(ref, got, channels=3):
    """(hit disagreement, colour mismatch) shares of the pixels of (..., 4)
    images or of (found, colour) pairs."""
    hit_r, hit_g = ref[..., 3] > 0.5, got[..., 3] > 0.5
    both = hit_r & hit_g
    err = (got[..., :channels] - ref[..., :channels]).abs().amax(-1)
    return ((hit_r != hit_g).float().mean().item(),
            ((err > 1e-6) & both).float().mean().item())


@pytest.mark.parametrize("w,h", [(96, 64), (200, 120)])
def test_billboard_kernel_matches_plain(cuda, w, h):
    """The billboard kernel against billboard_march_plain on the card, at
    both signs of cx and cx = 0 in one launch: found, tex and rgba equal
    (both follow the same float sequence); the epilogue with show_depth
    likewise."""
    rgb, disp, mask = _scene(w + 3 * h, h, w)
    f1, izmin, izmax = 0.78 * w, 2.0, 0.1
    cxs = [0.25, -0.18, 0.0]
    plan = tsm.translation_plan(w, h, w, h, f1 * 0.25 * izmin + 4.0, 0.0)
    ixs, mms, k = tbb.billboard_shift_tables(f1, cxs, izmin, izmax, plan)
    tex = [torch.from_numpy(a).to(cuda) for a in (rgb, disp, mask)]
    args = tbb.billboard_inputs(*tex, izmin, izmax, cxs, f1, ixs, mms, plan,
                                k, w / 2.0, h / 2.0, 1.0)
    before = tcuda_b.sweep_billboard.launches
    found, t_k, rgba = tcuda_b.sweep_billboard(*args)
    torch.cuda.synchronize()
    assert tcuda_b.sweep_billboard.launches == before + 1
    for i in range(len(cxs)):
        f_p, t_p, c_p = tbb.billboard_march_plain(
            args[0], args[1], args[2][i], args[3][i], args[4][i], *args[5:])
        got = torch.cat([c_p[..., :3], f_p[..., None]], -1)
        want = torch.cat([rgba[i][..., :3], found[i][..., None]], -1)
        flips, mism = _bb_disagreement(want, got)
        assert flips == 0.0 and mism == 0.0, (i, flips, mism)
        both = (f_p > 0) & (found[i] > 0)
        assert ((t_p - t_k[i]).abs() * both).max().item() == 0.0
        for show_depth in (False, True):
            a, b = (tbb.finish_billboard(fo[None], te[None], co[None],
                                         np.zeros(4), False, show_depth)[0]
                    for fo, te, co in ((found[i], t_k[i], rgba[i]),
                                       (f_p, t_p, c_p)))
            flips, mism = _bb_disagreement(a, b)
            assert flips == 0.0 and mism == 0.0, (i, show_depth, flips, mism)
    assert found.mean().item() > 0.5


@pytest.mark.parametrize("w,h,cxs,su", [
    (96, 64, [0.25], None),  # one pose
    (1000, 24, [0.1, -0.07, 0.0], None),  # W not a multiple of the block
    (200, 120, [0.2, -0.15, 0.05, 0.1, -0.02], 0.95),  # su/2 near 0.95
    (3840, 12, [0.05, -0.03], None),  # two poses' rows over 48 KB
])
def test_billboard_kernel_matches_scatter_plain(cuda, w, h, cxs, su):
    """The z-buffer scatter kernel against its plain version
    billboard_scatter_plain and the dual's billboard_march_plain: found,
    tex and rgba equal, at one pose, an odd pose group (5 poses), a width
    the 256-thread block does not divide, su/2 = 0.95 and W = 3840."""
    rgb, disp, mask = _scene(w + 7 * h, h, w)
    f1, izmin, izmax = 0.78 * w, 2.0, 0.1
    point_size = 1.0 if su is None else su / tbb.su_half_bound(1.0, w, h, f1)
    plan = tsm.translation_plan(w, h, w, h,
                                f1 * max(map(abs, cxs)) * izmin + 4.0, 0.0)
    ixs, mms, k = tbb.billboard_shift_tables(f1, cxs, izmin, izmax, plan)
    tex = [torch.from_numpy(a).to(cuda) for a in (rgb, disp, mask)]
    args = tbb.billboard_inputs(*tex, izmin, izmax, cxs, f1, ixs, mms, plan,
                                k, w / 2.0, h / 2.0, point_size)
    if su is not None:
        assert abs(float(args[4][0, 2]) - su) < 1e-3
    before = tcuda_b.sweep_billboard.launches
    out = tcuda_b.sweep_billboard(*args)
    torch.cuda.synchronize()
    assert tcuda_b.sweep_billboard.launches == before + 1
    for i in range(len(cxs)):
        one = (args[0], args[1], args[2][i], args[3][i], args[4][i], *args[5:])
        for plain in (tbb.billboard_scatter_plain, tbb.billboard_march_plain):
            for got, want in zip(out, plain(*one)):
                assert torch.equal(got[i], want), (i, plain.__name__)
    assert out[0].mean().item() > 0.5


def test_billboard_kernel_rejects_bad_inputs(cuda):
    """The wrapper refuses CPU tensors, int64 ladders and K > 1024."""
    disp = torch.rand(16, 16, device=cuda)
    rgbm = torch.rand(16, 16, 4, device=cuda)
    ab = torch.zeros(1, 3, device=cuda)
    ix = torch.zeros(1, 8, dtype=torch.int32, device=cuda)
    m = torch.zeros(1, 8, device=cuda)
    geo = (0, 8.0, 8.0, 0.1, 0.5)
    with pytest.raises(ValueError, match="CUDA"):
        tcuda_b.sweep_billboard(disp.cpu(), rgbm, ix, m, ab, *geo)
    with pytest.raises(ValueError, match="int32"):
        tcuda_b.sweep_billboard(disp, rgbm, ix.long(), m, ab, *geo)
    big = torch.zeros(1, 1100, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="1024"):
        tcuda_b.sweep_billboard(disp, rgbm, big, big.float(), ab, *geo)


def test_billboard_fast_batch_on_cuda_matches_cpu(cuda):
    """render_billboard_fast_batch on the card (one launch for 3 poses)
    equals the same call on CPU tensors (the plain twin), in sRGB over a
    background and with show_depth."""
    h, w = 96, 128
    rgb, disp, mask = _scene(21, h, w)
    proj = lif_tpu_torch.projector_from_arrays(
        rgb, disp, mask, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
        baseline=1.0, device="cpu")
    cams = [lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                        position=[x, 0.0, 0.0])
            for x in (0.1, -0.2, 0.03)]
    bg = (0.1, 0.2, 0.3, 0.5)
    for show_depth in (False, True):
        before = tcuda_b.sweep_billboard.launches
        got = lif_tpu_torch.render_billboard_fast_batch(
            proj.to(cuda), cams, background=bg, show_depth=show_depth)
        torch.cuda.synchronize()
        assert tcuda_b.sweep_billboard.launches == before + 1
        ref = lif_tpu_torch.render_billboard_fast_batch(
            proj, cams, background=bg, show_depth=show_depth)
        flips, mism = _bb_disagreement(ref, got.cpu())
        assert flips < 1e-3 and mism < 1e-3, (show_depth, flips, mism)


def test_splat_and_mesh_on_cuda_match_cpu(cuda):
    """forward_splat (render(mode='billboard')) and render_connected_mesh
    (render(mode='mesh')) on the card against the same calls on CPU
    tensors, at a lateral and a rotated pose: hit disagreement under 1e-3
    of the pixels (scatter-min and atomics are exact in any order; the
    divisions are true divisions on both), colour within 1e-4 elsewhere."""
    h, w = 96, 128
    rgb, disp, mask = _scene(22, h, w)
    proj = lif_tpu_torch.projector_from_arrays(
        rgb, disp, mask, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
        baseline=1.0, device="cpu")
    gpu = proj.to(cuda)
    for r, c in ((np.eye(3), [0.1, 0.0, 0.0]), (_roty(6.0), [0.05, 0.02, 0.0])):
        cam = lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                          position=c, rotation=r)
        for mode in ("billboard", "mesh"):
            ref = lif_tpu_torch.render(proj, cam, mode=mode)
            got = lif_tpu_torch.render(gpu, cam, mode=mode)
            assert got.device.type == "cuda"
            got = got.cpu()
            hit_r, hit_g = ref[..., 3] > 0.5, got[..., 3] > 0.5
            assert (hit_r != hit_g).float().mean().item() < 1e-3, mode
            err = (got - ref).abs().amax(-1)[hit_r & hit_g]
            assert (err > 1e-4).float().mean().item() < 1e-3, mode


def _skewed_ldi_cpu(h=64, w=128):
    """Two LDI layers, the back one outpainted by even margins, a
    fractional frustum skew on both axes; CPU textures."""
    rgb0, disp0, mask0 = _scene(31, h, w)
    rgb1, disp1, _ = _scene(32, h + 16, w + 32)
    return lif_tpu_torch.projector_from_arrays(
        rgb0, disp0, mask0, focal_px=0.78 * w, invz_min=2.0, invz_max=0.6,
        baseline=1.0, skew=(0.021, -0.0137), device="cpu",
        extra_layers=[dict(rgb=rgb1, disp=disp1, focal_px=0.78 * w,
                           invz_min=0.5, invz_max=0.1)],
    )


@pytest.mark.parametrize("refine", [0, 2])
def test_lateral_kernel_exact_on_a_preshifted_source(cuda, refine):
    """The skew fold's source on the card: the outpainted layer y-shifted
    by a fractional d[1] before its crop, d[0] in the snap phase and the
    warp offset, and the row tables _march_pack builds from that source.
    The kernel equals the plain march and its skip mirror bit for bit."""
    from lif_tpu_torch.models import renderer as trenderer

    proj = _skewed_ldi_cpu().to(cuda)
    lay = dict(trenderer._prepared_textures(proj)[1])
    h, w = 64, 128
    f1, izmin, izmax = lay["focal_host"], lay["izmin_host"], lay["izmax_host"]
    cxs = [0.03, -0.045, 0.06]
    plan, crop, phase, lay["doff"] = trenderer._march_fold(
        lay, proj.skew, (0.0, 0.0), 0.06, w, h, 0.0)
    assert lay["doff"][1] % 1.0 != 0.0  # a fractional y pre-shift
    srcs, _, rows = trenderer._march_pack(lay, plan, crop)
    planes, k = tsm.snap_plane_tables_batch(f1, cxs, izmin, izmax,
                                            phase_px=phase)
    c1 = np.stack([np.asarray(cxs, np.float32), np.zeros(3, np.float32),
                   np.zeros(3, np.float32)], -1)
    before = tcuda.sweep_lateral.launches
    found, invz, rgba = tcuda.march_translation_cuda(
        *srcs, izmin, izmax, c1, f1, torch.from_numpy(planes).to(cuda), plan,
        k, offset=(lay["doff"][0], 0.0), refine=refine, rows=rows)
    assert tcuda.sweep_lateral.launches == before + 1
    for i in range(3):
        for plain in (tsm.march_translation_plain,
                      tsm.march_translation_skip_plain):
            ref = plain(*srcs, izmin, izmax, c1[i], f1, planes[i], plan, k,
                        refine=refine, offset=lay["doff"])
            for got, want in zip((found[i], invz[i], rgba[i]), ref):
                assert torch.equal(got, want)
    assert found.mean().item() > 0.3


def test_fast_view_and_depth_on_cuda_match_cpu(cuda):
    """render_fast_view (a skewed lateral pose of the outpainted LDI: one
    lateral launch a layer; a y-only pose through the transpose),
    render_depth_fast (one launch) and a skewed render_fast_batch on the
    card equal the same calls on CPU tensors; load_lif_file puts the
    textures on the card by default."""
    from lif_tpu_torch.io import container, decode

    proj = _skewed_ldi_cpu()
    gpu = proj.to(cuda)
    w, h = 128, 64
    cam = lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                      position=[0.04, 0.0, 0.0],
                                      skew=(0.004, 0.0061))
    before = tcuda.sweep_lateral.launches
    got = lif_tpu_torch.render_fast_view(gpu, cam, to_srgb=False)
    assert tcuda.sweep_lateral.launches == before + 2
    ref = lif_tpu_torch.render_fast_view(proj, cam, to_srgb=False)
    assert got.device.type == "cuda"
    assert (got.cpu() - ref).abs().max().item() < 1e-5
    cams = [lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                        position=[x, 0.0, 0.0],
                                        skew=(0.004, 0.0061))
            for x in (-0.03, 0.05)]
    got = lif_tpu_torch.render_fast_batch(gpu, cams, to_srgb=False)
    ref = lif_tpu_torch.render_fast_batch(proj, cams, to_srgb=False)
    assert (got.cpu() - ref).abs().max().item() < 1e-5
    rgb, disp, mask = _scene(33, h, w)
    single = lif_tpu_torch.projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
        baseline=0.5, device="cpu")
    for pos in ([0.0, 0.03, 0.0], [0.05, 0.0, 0.0]):
        c = lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                        position=pos)
        got = lif_tpu_torch.render_fast_view(single.to(cuda), c,
                                             to_srgb=False)
        ref = lif_tpu_torch.render_fast_view(single, c, to_srgb=False)
        assert (got.cpu() - ref).abs().max().item() < 1e-5
    before = tcuda.sweep_lateral.launches
    got = lif_tpu_torch.render_depth_fast(single.to(cuda), c)
    assert tcuda.sweep_lateral.launches == before + 1
    ref = lif_tpu_torch.render_depth_fast(single, c)
    assert torch.equal(got.cpu(), ref)
    view = {"image": {"blob_id": 20}, "width_px": w, "height_px": h,
            "focal_px": 0.78 * w,
            "inv_z_map": {"blob_id": 21, "min": 2.0, "max": 0.1}}
    lif = container.write(b"", {"views": [view]},
                          {20: decode.encode_png(rgb),
                           21: decode.encode_png(disp)})
    loaded = lif_tpu_torch.load_lif_file(lif)
    assert loaded.projectors[0].disp.device.type == "cuda"


def test_mono_stereo_mono_marches_each_mask(cuda):
    """Mono, stereo, then mono again on one 2-layer LDI projector on the
    card. The lateral kernel's march packs are cached per texture layer
    and keyed on the mask they hold, so the mono calls march the texture's
    mask and the stereo call its eroded stereo mask. Each call agrees with
    the same call on CPU tensors (mono: max abs < 1e-4; stereo: the fast
    stereo gate, at most 0.1% of the pixels off by more than 1e-3), the
    launches are one per layer and eye, and the second mono frame equals
    the first bit for bit."""
    h, w = 64, 128
    rgb0, disp0, _ = _scene(1, h, w)
    rgb1, disp1, _ = _scene(2, h + 16, w + 32)
    masks = [np.ones((h, w), np.float32), np.ones((h + 16, w + 32),
                                                  np.float32)]
    for m in masks:
        m[10:30, 20:50] = 0.0
        m[40:44, 70:120] = 0.0
    proj = lif_tpu_torch.projector_from_arrays(
        rgb0, disp0, masks[0], focal_px=0.78 * w, invz_min=2.0,
        invz_max=0.6, baseline=1.0, device="cpu",
        extra_layers=[dict(rgb=rgb1, disp=disp1, mask=masks[1],
                           focal_px=0.78 * w, invz_min=0.5, invz_max=0.1)],
    )
    pairs = []
    for p in (proj, proj.to(cuda)):
        pairs.append((p, dataclasses.replace(
            p, position=np.array([0.06, 0.0, 0.0], np.float32))))
    cam = lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                      position=[0.02, 0.0, 0.0])
    mono_ref = lif_tpu_torch.render_fast_view(pairs[0][0], cam)
    stereo_ref = lif_tpu_torch.render_stereo_fast(*pairs[0], cam)
    frames = []
    for step in ("mono", "stereo", "mono"):
        before = tcuda.sweep_lateral.launches
        if step == "mono":
            frames.append(lif_tpu_torch.render_fast_view(pairs[1][0], cam))
        else:
            frames.append(lif_tpu_torch.render_stereo_fast(*pairs[1], cam))
        torch.cuda.synchronize()
        assert tcuda.sweep_lateral.launches == before + (
            2 if step == "mono" else 4)
    assert (frames[0].cpu() - mono_ref).abs().max().item() < 1e-4
    err = (frames[1].cpu() - stereo_ref).abs().amax(-1)
    assert (err > 1e-3).float().mean().item() <= 1e-3
    assert torch.equal(frames[2], frames[0])
    # both eyes share the textures, so one texture-cache entry holds the
    # packs of all three calls: each holds the texture's mask or the
    # eroded one
    for lay in trenderer._prepared_textures(pairs[1][0]):
        held = {id(mask) for mask, _ in lay["march_packs"].values()}
        assert held == {id(lay["mask"]), id(lay["eroded_mask"])}


def test_stereo_rotated_eyes_on_cuda_match_cpu(cuda):
    """A stereo pair at +-0.03 m seen from a yaw + pitch head pose (tests/
    test_torch_stereo_fast.py's 'rotated' case): both eyes route the
    two-phase tier, whose phase A launches the scaled kernel once per eye
    on the card, and the pair agrees with the same call on CPU tensors
    under the fast-stereo gate (at most 0.1% of the pixels off by more
    than 1e-3)."""
    h, w = 64, 96
    rgb, disp, _ = _scene(7, h, w)
    eyes = [lif_tpu_torch.projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
        baseline=1.0, position=(x, 0.0, 0.0), device="cpu")
        for x in (-0.03, 0.03)]
    rot = lif_tpu_torch.orbit_pose([0, 0, -1], 1.0, 0.06, 0.04)[1]
    cams = [lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                        position=[0.01, 0.0, 0.0],
                                        rotation=rot)]
    ref, tiers = lif_tpu_torch.render_stereo_fast_batch(
        *eyes, cams, to_srgb=False, return_tiers=True)
    assert tiers == (("rotated",), ("rotated",))
    before = tcuda_s.sweep_scaled.launches
    got, tiers = lif_tpu_torch.render_stereo_fast_batch(
        *(e.to(cuda) for e in eyes), cams, to_srgb=False, return_tiers=True)
    torch.cuda.synchronize()
    assert tiers == (("rotated",), ("rotated",))
    assert tcuda_s.sweep_scaled.launches == before + 2
    err = (got.cpu() - ref).abs().amax(-1)
    assert (err > 1e-3).float().mean().item() <= 1e-3
    assert (got[..., 3] > 0.5).float().mean().item() > 0.5


def test_stereo_ldi_cell_call_on_cuda_matches_cpu(cuda):
    """One call of the benchmark's stereo cell (sfmoma.stereo) at its full
    size: 48 pairs over two 3-layer views of 1408x928 layers, in two pose
    chunks. On the card every eye-layer takes the lateral kernel once a
    chunk (12 launches). The same cameras' frames agree with the call on
    CPU tensors under the fast-stereo gate (at most 0.1% of the pixels
    off by more than 1e-3). The CPU call renders 4 of the 96 cameras: the
    first and last of each chunk, which hold every view's largest offset,
    so each ladder, plan and weight is the full call's."""
    from pathlib import Path

    from benchmark.lifbench import harness, parts, traffic

    cell = harness.Cell(Path(__file__).resolve().parents[1], "sfmoma.stereo")
    scene = parts.load("scenes", cell.config["scene"])
    srcs = scene.build(cell.config, 2**31 + 2409, cuda)
    projs = scene.projectors(lif_tpu_torch, srcs, cell.config)
    poses = traffic.PoseStream(cell.traffic,
                               np.random.default_rng(2409)).next()
    cams = traffic.cameras(lif_tpu_torch, poses, cell.config)
    cfg = lif_tpu_torch.RenderConfig(**cell.config["render_config"])
    before = tcuda.sweep_lateral.launches
    got, tiers = lif_tpu_torch.render_stereo_fast_batch(
        *projs, cams, config=cfg, return_tiers=True)
    torch.cuda.synchronize()
    assert got.shape == (96, 800, 1280, 4)
    assert tiers == (("march",) * 3,) * 2
    assert tcuda.sweep_lateral.launches == before + 12
    pick = [0, 47, 48, 95]
    ref = lif_tpu_torch.render_stereo_fast_batch(
        *(p.to("cpu") for p in projs), [cams[j] for j in pick], config=cfg)
    err = (got[pick].cpu() - ref).abs().amax(-1)
    assert (err > 1e-3).float().mean().item() <= 1e-3
    assert (got[..., 3] > 0.5).float().mean().item() > 0.9


def test_fused_fast_on_cuda_matches_cpu(cuda):
    """render_fused_fast_batch on the card, two 2-layer LDI projectors at
    three poses: exactly one lateral launch per projector and layer (one
    pose chunk), and the frames equal to the same call on CPU tensors to
    max abs < 1e-4 outside the pixels where one projector's composited
    alpha is > 0 on one device and 0 on the other (the merge can turn
    such a rounding-level alpha into the winning hit), which may be at
    most 0.1% of the pixels."""
    h, w = 64, 128
    cpu, card = [], []
    for i, x in enumerate((-0.02, 0.02)):
        rgb0, disp0, mask0 = _scene(10 + i, h, w)
        rgb1, disp1, mask1 = _scene(20 + i, h, w)
        proj = lif_tpu_torch.projector_from_arrays(
            rgb0, disp0, mask0, focal_px=0.78 * w, invz_min=2.0,
            invz_max=0.6, baseline=1.0, position=(x, 0.0, 0.0),
            device="cpu",
            extra_layers=[dict(rgb=rgb1, disp=disp1, mask=mask1,
                               focal_px=0.78 * w, invz_min=0.5,
                               invz_max=0.1)],
        )
        cpu.append(proj)
        card.append(proj.to(cuda))
    cams = [lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                        position=[x, 0.0, 0.0])
            for x in (-0.01, 0.004, 0.015)]
    ref = lif_tpu_torch.render_fused_fast_batch(cpu, cams)
    before = tcuda.sweep_lateral.launches
    got = lif_tpu_torch.render_fused_fast_batch(card, cams)
    torch.cuda.synchronize()
    assert tcuda.sweep_lateral.launches == before + 4
    assert got.device.type == "cuda" and got.shape == ref.shape
    flips = torch.zeros(ref.shape[:3], dtype=torch.bool)
    for p_cpu, p_card in zip(cpu, card):
        kw = dict(to_srgb=False, background=(0.0, 0.0, 0.0, 0.0),
                  mask_mode="multiply")
        a_cpu = lif_tpu_torch.render_fast_batch(p_cpu, cams, **kw)[..., 3]
        a_card = lif_tpu_torch.render_fast_batch(p_card, cams, **kw)[..., 3]
        flips |= (a_cpu > 0.0) != (a_card.cpu() > 0.0)
    assert flips.float().mean().item() <= 1e-3
    err = (got.cpu() - ref).abs().amax(-1)
    assert err[~flips].max().item() < 1e-4


def _sweep_counts():
    return (tcuda.sweep_lateral.launches, tcuda_t.sweep_target.launches,
            tcuda_s.sweep_scaled.launches, tcuda_b.sweep_billboard.launches)


@pytest.mark.parametrize("kw", [dict(method="sweep"),
                                dict(method="sweep", exact_color=True)])
def test_sweep_on_cuda_matches_cpu(cuda, kw):
    """The plane sweep on the card launches no kernel and equals the CPU
    port's frames (its products sum two banded taps a row, so the card's
    order of summation changes nothing beyond float32 rounding: max abs
    < 1e-4), also for a rotated pose (render_rotated)."""
    rgb, disp, mask = _scene(5, 96, 128)
    kw_p = dict(focal_px=0.78 * 128, invz_min=2.0, invz_max=0.1,
                baseline=1.0)
    cams = [lif_tpu_torch.Camera.create(128, 96, focal_px=0.78 * 128,
                                        position=[0.03 * i, 0.01, 0.0])
            for i in range(3)]
    rot = lif_tpu_torch.orbit_pose([0, 0, -1], 1.0, 0.1, 0.05)
    cams.append(lif_tpu_torch.Camera.create(
        128, 96, focal_px=0.78 * 128, position=rot[0], rotation=rot[1]))
    for batch in (cams[:3], cams[3:]):
        outs = []
        for dev in (cuda, "cpu"):
            proj = lif_tpu_torch.projector_from_arrays(rgb, disp, mask,
                                                       device=dev, **kw_p)
            before = _sweep_counts()
            out, tiers = lif_tpu_torch.render_fast_batch(
                proj, batch, return_tiers=True, **kw)
            assert tiers == ("sweep",) and _sweep_counts() == before
            outs.append(out.cpu())
        assert (outs[0] - outs[1]).abs().max().item() < 1e-4


def test_fit_step_on_cuda_matches_cpu(cuda):
    """Two fit steps on the card: the losses within 1e-4 relative of the
    CPU port's (the gathers' backward accumulates with atomics on the
    card, in no fixed order) and no kernel launched."""
    from lif_tpu_torch.train import fit

    rgb, disp, _ = _scene(9, 24, 32)
    kw = dict(focal_px=0.78 * 32, invz_min=2.0, invz_max=0.2, baseline=1.0)
    positions = np.stack([[0.05 * (i - 2), 0.02 * i + 0.001, 0.0]
                          for i in range(4)])
    rotations = np.stack([np.eye(3)] * 4)
    cam = lif_tpu_torch.Camera.create(32, 24, focal_px=0.78 * 32)
    start = np.clip(disp + 0.1 * np.sin(np.arange(disp.size)).reshape(
        disp.shape), 0, 1).astype(np.float32)
    histories = []
    for dev in (cuda, "cpu"):
        true_proj = lif_tpu_torch.projector_from_arrays(rgb, disp, device=dev,
                                                        **kw)
        rel_p, rel_r = fit.relative_poses(true_proj, positions, rotations)
        zero = torch.zeros(3, device=dev)
        with torch.no_grad():
            targets = fit.render_with_params(
                fit.FitParams(true_proj.disp, zero, zero),
                fit.static_projector(true_proj, cam),
                torch.as_tensor(rel_p, device=dev),
                torch.as_tensor(rel_r, device=dev), 32, 24, 1, 12)
        bad = lif_tpu_torch.projector_from_arrays(rgb, start, device=dev,
                                                  **kw)
        before = _sweep_counts()
        params, losses = fit.fit_projector(bad, positions, rotations, cam,
                                           targets, steps=2)
        assert _sweep_counts() == before
        assert params.disp.device.type == torch.device(dev).type
        histories.append(losses)
    np.testing.assert_allclose(histories[0], histories[1], rtol=1e-4)


def _traced_routes(cuda):
    """route -> a call on the card of each fast entry point and tier."""
    h, w = 112, 128
    rgb0, disp0, mask0 = _scene(30, h, w)
    rgb1, disp1, _ = _scene(31, h + 16, w + 32)
    kw = dict(focal_px=0.78 * w, invz_min=2.0, invz_max=0.6, baseline=1.0)
    ldi = lif_tpu_torch.projector_from_arrays(
        rgb0, disp0, mask0, device="cpu", **kw,
        extra_layers=[dict(rgb=rgb1, disp=disp1, focal_px=0.78 * w,
                           invz_min=0.5, invz_max=0.1)]).to(cuda)
    one = lif_tpu_torch.projector_from_arrays(rgb0, disp0, device=cuda, **kw)
    other = lif_tpu_torch.projector_from_arrays(
        rgb0, disp0, device=cuda, position=(0.02, 0.0, 0.0), **kw)
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=2)

    def cams(poses):
        return [lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                            position=c, rotation=r)
                for r, c in poses]

    lateral = cams([(np.eye(3), [x, 0.0, 0.0]) for x in (0.01, 0.02, 0.03)])
    return {
        "lateral": lambda: lif_tpu_torch.render_fast_batch(
            ldi, lateral, config=cfg),
        "view": lambda: lif_tpu_torch.render_fast_view(ldi, lateral[1]),
        "dolly": lambda: lif_tpu_torch.render_fast_batch(ldi, cams(
            [(np.eye(3), [0.03, 0.01, 0.02]),
             (np.eye(3), [0.0, -0.01, 0.04])]), config=cfg),
        "orbit": lambda: lif_tpu_torch.render_fast_batch(ldi, cams(
            [(_roty(-6.0), [-0.1, 0.0, 0.01]),
             (_roty(8.0), [0.15, 0.0, -0.01])]), config=cfg),
        "tilt": lambda: lif_tpu_torch.render_fast_batch(ldi, cams(
            [(_rotx(6.0), [0.1, 0.0, 0.0]), (_rotx(-4.0), [0.0, 0.05, 0.0])]),
            config=cfg),
        "rotated": lambda: lif_tpu_torch.render_fast_batch(ldi, cams(
            [(_rotx(3.0) @ _roty(4.0), [0.05, 0.01, 0.0]),
             (_rotx(-2.0) @ _roty(-3.0), [-0.04, 0.0, 0.01])]), config=cfg),
        "fused": lambda: lif_tpu_torch.render_fused_fast_batch(
            [one, other], lateral, config=cfg),
        "stereo": lambda: lif_tpu_torch.render_stereo_fast_batch(
            ldi, ldi, lateral, config=cfg),
        "billboard": lambda: lif_tpu_torch.render_billboard_fast_batch(
            one, lateral),
        "sweep": lambda: lif_tpu_torch.render_fast_batch(
            ldi, lateral[:2], method="sweep", num_planes=32),
        "sweep_rotated": lambda: lif_tpu_torch.render_fast_batch(
            ldi, cams([(_roty(-6.0), [-0.1, 0.0, 0.01])]), method="sweep",
            num_planes=32),
    }


@pytest.mark.parametrize("route", ["lateral", "view", "dolly", "orbit",
                                   "tilt", "rotated", "fused", "stereo",
                                   "billboard", "sweep", "sweep_rotated"])
def test_host_syncs_counted_on_the_card(cuda, route):
    """utils.profiling on the card: over two calls of each route (after a
    warm-up, so the caches hold their entries as in a steady loop, and
    once more with every cache cleared) the sync.* counters equal the
    cudaStreamSynchronize runtime calls in the profiler's events, the
    snapshot has one root a call, and every kernel span that recorded
    also annotates the device."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lif_tpu_torch.utils import profiling

    fn = _traced_routes(cuda)[route]
    fn()
    torch.cuda.synchronize()
    for cold in (False, True):
        if cold:
            for name in dir(trenderer):
                if name.endswith("_CACHE"):
                    getattr(trenderer, name).clear()
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            fn()
            torch.cuda.synchronize()
        snap = profiling.snapshot()
        events = list(prof.profiler.kineto_results.events())
        waits = sum(e.name() == "cudaStreamSynchronize" for e in events)
        syncs = sum(n for k, n in snap["counters"].items()
                    if k.startswith("sync."))
        assert snap["calls"] == 2
        assert syncs == waits, (cold, snap["counters"])
        annotated = {e.name() for e in events
                     if e.device_type() == DeviceType.CUDA
                     and e.is_user_annotation()}
        kernels = {k for k in snap["spans"] if k.startswith("lif.kernel.")}
        assert kernels <= annotated
        assert kernels or route.startswith("sweep")


def _epilogue_projector(layers, h, w, skew=(0.0, 0.0), cuda=None):
    """One layer, or three: the back two outpainted by even margins (16
    and 8 rows, 32 and 16 columns), every layer masked; on the card."""
    rgb0, disp0, mask0 = _scene(w + h, h, w)
    extra = []
    for i, (dh, dw) in enumerate(((16, 32), (8, 16))[: layers - 1]):
        rgb, disp, mask = _scene(w + h + i + 1, h + dh, w + dw)
        extra.append(dict(rgb=rgb, disp=disp, mask=mask, focal_px=0.78 * w,
                          invz_min=0.5 - 0.1 * i, invz_max=0.1))
    return lif_tpu_torch.projector_from_arrays(
        rgb0, disp0, mask0 if layers > 1 else None, focal_px=0.78 * w,
        invz_min=2.0, invz_max=0.6, baseline=1.0, skew=skew, device=cuda,
        extra_layers=extra)


def _fused_against_chain(proj, cams, monkeypatch, **kw):
    """(frames through the epilogue kernel, frames through the PyTorch
    chain on the card, epilogue launches, epilogue.lateral.fused count)
    of one render_fast_batch call."""
    from torch.profiler import ProfilerActivity, profile

    from lif_tpu_torch.utils import profiling

    kw = dict(kw, method="march")
    lateral = tcuda.sweep_lateral.launches
    before = tcuda.lateral_epilogue.launches
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = lif_tpu_torch.render_fast_batch(proj, cams, **kw)
        torch.cuda.synchronize()
    fused = profiling.snapshot()["counters"].get("epilogue.lateral.fused", 0)
    launches = tcuda.lateral_epilogue.launches - before
    assert tcuda.sweep_lateral.launches - lateral == launches
    with monkeypatch.context() as m:
        m.setattr(trenderer, "_fuses_epilogue", lambda modes: False)
        ref = lif_tpu_torch.render_fast_batch(proj, cams, **kw)
    assert tcuda.lateral_epilogue.launches - before == launches
    return got, ref, launches, fused


_BG = (0.1, 0.2, 0.3, 0.7)


@pytest.mark.parametrize("case", [
    # (layers, width, poses, pose_chunk, mask_mode, to_srgb, skewed, bg)
    (3, 128, 5, 2, "none", True, False, "host"),
    (3, 128, 5, 2, "multiply", True, False, "host"),
    (3, 128, 5, 2, "hard", True, False, "host"),
    (3, 128, 3, 2, "multiply", False, False, "host"),
    (3, 124, 3, 2, "multiply", True, False, "host"),
    (3, 128, 3, 2, "multiply", True, True, "host"),
    (1, 124, 3, 2, None, True, False, "cuda"),
], ids=["ldi-none", "ldi-multiply", "ldi-hard", "ldi-linear",
        "ldi-odd-width", "ldi-skew-outpainted", "cuda-background"])
def test_lateral_epilogue_kernel_equals_the_chain(cuda, case, monkeypatch):
    """render_fast_batch through the epilogue kernel equals the same call
    through the PyTorch chain on the card bit for bit (max |diff| 0),
    with one epilogue launch (and one epilogue.lateral.fused count) for
    each march launch: pose chunks x layers."""
    layers, w, n, chunk, mask_mode, to_srgb, skewed, bg = case
    h = 96
    skew = (0.021, -0.0137) if skewed else (0.0, 0.0)
    proj = _epilogue_projector(layers, h, w, skew, cuda)
    cams = [lif_tpu_torch.Camera.create(
        w, h, focal_px=0.78 * w, position=[0.01 + 0.007 * i, 0.0, 0.0],
        skew=(0.004, 0.0061) if skewed else (0.0, 0.0)) for i in range(n)]
    background = torch.tensor(_BG, device=cuda) if bg == "cuda" else _BG
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=chunk)
    got, ref, launches, fused = _fused_against_chain(
        proj, cams, monkeypatch, config=cfg, background=background,
        to_srgb=to_srgb, mask_mode=mask_mode)
    chunks = len(trenderer._pose_chunks(n, chunk))
    assert launches == fused == chunks * layers
    assert got.shape == ref.shape == (n, h, w, 4)
    assert (got - ref).abs().max().item() == 0.0
    assert torch.equal(got, ref)


@pytest.mark.parametrize("n", [432, 430])
def test_lateral_epilogue_kernel_at_the_main_path_shape(cuda, n,
                                                        monkeypatch):
    """The main path's call: a one-layer 1280x800 projector, n lateral
    poses in chunks of 48 (430: a ragged last chunk of 46), through the
    epilogue kernel and through the PyTorch chain: max |diff| 0, one
    epilogue launch a chunk."""
    h, w = 800, 1280
    rgb, disp, _ = _scene(7, h, w)
    proj = lif_tpu_torch.projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=0.09 / 0.045,
        invz_max=0.0001 / 0.045, baseline=0.045, device=cuda)
    cams = [lif_tpu_torch.Camera.create(
        w, h, focal_px=0.78 * w, position=[0.135 + 0.02 * i / n, 0.0, 0.0])
        for i in range(n)]
    posed = tpe.posed_epilogue.launches
    got, ref, launches, fused = _fused_against_chain(proj, cams,
                                                     monkeypatch)
    assert launches == fused == 9
    assert tpe.posed_epilogue.launches == posed
    assert (got - ref).abs().max().item() == 0.0
    del got, ref


def test_mixed_tier_ldi_takes_both_epilogue_kernels(cuda):
    """An LDI whose front layer is not march-eligible (another focal: the
    scaled tier) in front of a march layer finishes in place: one lateral
    and one posed epilogue launch a chunk, each counted; the single view
    of the march-only projector takes the lateral one alone (one launch a
    layer)."""
    from torch.profiler import ProfilerActivity, profile

    from lif_tpu_torch.utils import profiling

    h, w = 96, 128
    rgb0, disp0, mask0 = _scene(40, h, w)
    rgb1, disp1, mask1 = _scene(41, h, w)
    mixed = lif_tpu_torch.projector_from_arrays(
        rgb0, disp0, mask0, focal_px=0.9 * w, invz_min=2.0, invz_max=0.6,
        baseline=1.0, device=cuda,
        extra_layers=[dict(rgb=rgb1, disp=disp1, mask=mask1,
                           focal_px=0.78 * w, invz_min=0.5, invz_max=0.1)])
    cams = [lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                        position=[x, 0.0, 0.0])
            for x in (0.01, 0.02, 0.03)]
    lateral = tcuda.lateral_epilogue.launches
    posed = tpe.posed_epilogue.launches
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _, tiers = lif_tpu_torch.render_fast_batch(mixed, cams,
                                                   return_tiers=True)
        torch.cuda.synchronize()
    counters = profiling.snapshot()["counters"]
    assert tiers == ("scaled", "march")
    assert tcuda.lateral_epilogue.launches == lateral + 1
    assert tpe.posed_epilogue.launches == posed + 1
    assert counters["epilogue.lateral.fused"] == 1
    assert counters["epilogue.scaled.fused"] == 1
    ldi = _epilogue_projector(3, h, w, cuda=cuda)
    lif_tpu_torch.render_fast_view(ldi, cams[1])
    torch.cuda.synchronize()
    assert tcuda.lateral_epilogue.launches == lateral + 4
    assert tpe.posed_epilogue.launches == posed + 1


def test_lateral_epilogue_rejects_bad_inputs(cuda):
    """The wrapper raises on what the kernel does not take: a true width
    beyond the march's, a plan of other dims, a CPU pose table, an
    unknown mask mode."""
    b, h, w = 2, 16, 32
    found = torch.ones((b, h, w), device=cuda)
    invz = torch.full((b, h, w), 0.5, device=cuda)
    rgba = torch.rand((b, h, w, 4), device=cuda)
    c1 = torch.zeros((b, 3), device=cuda)
    plan = tsm.translation_plan(w, h, w, h, 4.0, 0.0)
    kw = dict(feathering=0.1, mask_mode="none", to_srgb=True)
    out = torch.empty((b, h, w, 4), device=cuda)
    tcuda.lateral_epilogue(found, invz, rgba, c1, plan, 30.0, _BG, out, **kw)
    with pytest.raises(ValueError):
        tcuda.lateral_epilogue(found, invz, rgba, c1, plan, 30.0, _BG,
                               torch.empty((b, h, w + 8, 4), device=cuda),
                               **kw)
    with pytest.raises(ValueError):
        tcuda.lateral_epilogue(found, invz, rgba, c1,
                               tsm.translation_plan(w, h, w + 8, h, 4.0, 0.0),
                               30.0, _BG, out, **kw)
    with pytest.raises(ValueError):
        tcuda.lateral_epilogue(found, invz, rgba, c1.cpu(), plan, 30.0, _BG,
                               out, **kw)
    with pytest.raises(ValueError):
        tcuda.lateral_epilogue(found, invz, rgba, c1, plan, 30.0, _BG, out,
                               **dict(kw, mask_mode="soft"))


def _posed_drive(cuda, tier, n, w=1280, h=800):
    """The camera path's orbit ('target': yaw theta from -15 deg over 28
    deg about (0, 0, -1) m at 1 m) or push-in ('scaled': z from 0.1 m
    over 0.09 m) of n poses over the smoke's seeded w x h scene, on the
    card."""
    from lif_tpu_torch.bench.scenes import scene_projector

    proj = scene_projector(lif_tpu_torch, 0, w=w, h=h, device=cuda)
    f = float(proj.focal[0])
    if tier == "target":
        poses = [lif_tpu_torch.orbit_pose([0.0, 0.0, -1.0], 1.0,
                                          np.deg2rad(-15.0 + 28.0 * i / n))
                 for i in range(n)]
    else:
        poses = [([0.0, 0.0, 0.1 + 0.09 * i / n], np.eye(3))
                 for i in range(n)]
    return proj, [lif_tpu_torch.Camera.create(w, h, focal_px=f, position=p,
                                              rotation=r) for p, r in poses]


def _posed_against_chain(proj, cams, monkeypatch, **kw):
    """(frames through the posed epilogue kernel, frames through the
    PyTorch chain on the card, posed epilogue launches, the
    epilogue.<tier>.fused counts) of one render_fast_batch call."""
    from torch.profiler import ProfilerActivity, profile

    from lif_tpu_torch.utils import profiling

    before = tpe.posed_epilogue.launches
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = lif_tpu_torch.render_fast_batch(proj, cams, **kw)
        torch.cuda.synchronize()
    counters = profiling.snapshot()["counters"]
    fused = {t: counters.get(f"epilogue.{t}.fused", 0)
             for t in ("target", "scaled")}
    launches = tpe.posed_epilogue.launches - before
    with monkeypatch.context() as m:
        m.setattr(trenderer, "_fuses_epilogue", lambda modes: False)
        ref = lif_tpu_torch.render_fast_batch(proj, cams, **kw)
    assert tpe.posed_epilogue.launches - before == launches
    return got, ref, launches, fused


_ORBIT = [(_roty(-6.0), [-0.1, 0.0, 0.01]), (_roty(0.0), [0.0, 0.0, 0.0]),
          (_roty(8.0), [0.15, 0.0, -0.01])]
_ZOOM = [(np.eye(3), [0.004, 0.002, 0.03 + 0.01 * i]) for i in range(3)]


@pytest.mark.parametrize("case", [
    # (layers, width, poses, focal of the back layer and the camera,
    #  mask_mode, to_srgb, background, tiers)
    (1, 128, "orbit", 0.78, "none", True, "host", ("target",)),
    (1, 128, "orbit", 0.78, "multiply", False, "host", ("target",)),
    (3, 128, "orbit", 0.78, "hard", True, "host", ("target",) * 3),
    (1, 128, "zoom", 0.78, "none", True, "cuda", ("scaled",)),
    (3, 128, "zoom", 0.78, "multiply", True, "host", ("scaled",) * 3),
    (3, 124, "zoom", 0.78, "hard", False, "host", ("scaled",) * 3),
    (2, 124, "lateral", 0.9, "multiply", True, "host", ("scaled", "march")),
], ids=["orbit", "orbit-linear", "orbit-ldi-hard", "zoom-cuda-background",
        "zoom-ldi", "zoom-ldi-odd-width", "scaled-over-padded-march"])
def test_posed_epilogue_kernel_equals_the_chain(cuda, case, monkeypatch):
    """render_fast_batch through the posed epilogue kernel equals the same
    call through the PyTorch chain on the card bit for bit (max |diff|
    0), with one posed launch (and one epilogue.<tier>.fused count) for
    each target or scaled layer of each pose chunk."""
    layers, w, kind, focal, mask_mode, to_srgb, bg, tiers = case
    h = 96
    rgb0, disp0, mask0 = _scene(50, h, w)
    extra = []
    for i in range(layers - 1):
        rgb, disp, mask = _scene(51 + i, h + 16, w + 32)
        extra.append(dict(rgb=rgb, disp=disp, mask=mask, focal_px=focal * w,
                          invz_min=0.5 - 0.1 * i, invz_max=0.1))
    proj = lif_tpu_torch.projector_from_arrays(
        rgb0, disp0, mask0, focal_px=0.78 * w, invz_min=2.0, invz_max=0.6,
        baseline=1.0, device=cuda, extra_layers=extra)
    poses = {"orbit": _ORBIT, "zoom": _ZOOM,
             "lateral": [(np.eye(3), [0.01 * (i + 1), 0.0, 0.0])
                         for i in range(3)]}[kind]
    cams = [lif_tpu_torch.Camera.create(w, h, focal_px=focal * w,
                                        position=c, rotation=r)
            for r, c in poses]
    background = torch.tensor(_BG, device=cuda) if bg == "cuda" else _BG
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=2)
    _, got_tiers = lif_tpu_torch.render_fast_batch(
        proj, cams, config=cfg, return_tiers=True)
    assert got_tiers == tiers
    got, ref, launches, fused = _posed_against_chain(
        proj, cams, monkeypatch, config=cfg, background=background,
        to_srgb=to_srgb, mask_mode=mask_mode)
    chunks = len(trenderer._pose_chunks(len(cams), 2))
    assert launches == sum(fused.values()) == chunks * sum(
        t != "march" for t in tiers)
    assert got.shape == ref.shape == (len(cams), h, w, 4)
    assert (got - ref).abs().max().item() == 0.0
    assert torch.equal(got, ref)


@pytest.mark.parametrize("tier", ["target", "scaled"])
def test_posed_epilogue_kernel_at_the_main_path_shape(cuda, tier):
    """One 48-pose chunk of the camera path's orbit or push-in at
    1280x800: the kernel equals its plain version on the tier's own march
    outputs bit for bit, finishing a front layer (over the background,
    sRGB) and a layer behind one already in `out`."""
    from lif_tpu_torch.ops.sampling import pack_rgbm

    proj, cams = _posed_drive(cuda, tier, 48)
    tp = trenderer.plan_tiers(proj, cams)
    mode, setup, extra = tp.planned[0]
    assert mode == tier
    lay = trenderer._prepared_textures(proj)[0]
    izmin, izmax = lay["izmin_host"], lay["izmax_host"]
    packed = pack_rgbm(lay["rgb"], lay["mask"])
    if tier == "target":
        plan, k = setup
        poses = extra["pose_sc"]
        found, invz = tst._march_batch(
            lay["disp"], izmin, izmax, poses, extra["grids"], plan, k,
            lif_tpu_torch.DEFAULT_CONFIG.target_refine,
            skip_tables=lay["skip_target"])
        solve = (plan, izmin, izmax)
    else:
        plan, k, fr, dxu, dyu = setup
        poses = torch.as_tensor(tp.pos_b, dtype=torch.float32, device=cuda)
        found, invz = tss.render_scaled_batch(
            lay["rgb"], lay["disp"], lay["mask"], izmin, izmax, poses,
            lay["focal_host"], fr, extra["grids"], None, plan, k,
            refine=lif_tpu_torch.DEFAULT_CONFIG.rotated_refine,
            dx_user=dxu, dy_user=dyu, depth_only=True,
            skip_tables=lay["skip_scaled"])
        solve = (plan, lay["focal_host"], fr, dxu, dyu, 0)
    args = (tier, found, invz, poses, solve, packed, _BG)
    for first, last in ((True, True), (False, True), (True, False)):
        out = torch.rand((48, 800, 1280, 4), device=cuda)
        twin = out.clone()
        kw = dict(feathering=0.1, mask_mode="multiply", to_srgb=True,
                  first=first, last=last)
        tpe.posed_epilogue(*args, out, **kw)
        tpe.posed_epilogue_plain(*args, twin, **kw)
        torch.cuda.synchronize()
        assert (out - twin).abs().max().item() == 0.0
        assert torch.equal(out, twin)
        del out, twin


@pytest.mark.parametrize("tier", ["target", "scaled"])
def test_posed_call_launches_one_epilogue_a_chunk(cuda, tier):
    """A 144-pose camera-path segment (orbit or push-in) at 1280x800:
    three pose chunks, so three march launches, three posed epilogue
    launches and three epilogue.<tier>.fused counts; no lateral epilogue;
    no channel or chunk concatenation in the device trace: the orbit has
    no CatArrayBatchedCopy, the push-in one a chunk, the stack of its
    march's (B, 5, K) plane tables (scaled_table_stack), a few
    microseconds where a chunk's frames would take about half a
    millisecond."""
    from torch.profiler import ProfilerActivity, profile

    from lif_tpu_torch.utils import profiling

    proj, cams = _posed_drive(cuda, tier, 144)
    lif_tpu_torch.render_fast_batch(proj, cams)  # plans and warms up
    torch.cuda.synchronize()
    wrapper = tcuda_t.sweep_target if tier == "target" else \
        tcuda_s.sweep_scaled
    marches = wrapper.launches
    posed = tpe.posed_epilogue.launches
    lateral = tcuda.lateral_epilogue.launches
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, tiers = lif_tpu_torch.render_fast_batch(proj, cams,
                                                     return_tiers=True)
        torch.cuda.synchronize()
    counters = profiling.snapshot()["counters"]
    assert tiers == (tier,)
    assert tuple(out.shape) == (144, 800, 1280, 4) and out.is_contiguous()
    assert wrapper.launches - marches == 3
    assert tpe.posed_epilogue.launches - posed == 3
    assert counters[f"epilogue.{tier}.fused"] == 3
    assert tcuda.lateral_epilogue.launches == lateral
    events = prof.key_averages()
    assert any("posed_epilogue_kernel" in e.key for e in events)
    cats = [e for e in events if "CatArrayBatchedCopy" in e.key]
    if tier == "target":
        assert not cats
    else:
        assert sum(e.count for e in cats) == 3
        assert sum(e.device_time_total for e in cats) < 100.0  # us


def test_posed_epilogue_rejects_bad_inputs(cuda):
    """The wrapper raises on what the kernel does not take: a true width
    beyond the march's, a plan of other dims, a pose table of the other
    tier's width, a float texture, a CPU pose table, an unknown mask mode
    or tier."""
    from lif_tpu_torch.ops.sampling import pack_rgbm

    b, h, w = 2, 16, 32
    found = torch.ones((b, h, w), device=cuda)
    invz = torch.full((b, h, w), 0.5, device=cuda)
    poses = torch.zeros((b, 16), device=cuda)
    packed = pack_rgbm(torch.rand((h, w, 3), device=cuda),
                       torch.ones((h, w), device=cuda))
    plan = tst.TargetPlan(*([0] * len(tst.TargetPlan._fields)))._replace(
        src_w=w, src_h=h, out_w=w, out_h=h)
    solve = (plan, 2.0, 0.6)
    kw = dict(feathering=0.1, mask_mode="none", to_srgb=True)
    out = torch.empty((b, h, w, 4), device=cuda)
    tpe.posed_epilogue("target", found, invz, poses, solve, packed, _BG,
                       out, **kw)
    bad = [
        dict(out=torch.empty((b, h, w + 8, 4), device=cuda)),
        dict(solve=(plan._replace(out_w=w + 8), 2.0, 0.6)),
        dict(poses=torch.zeros((b, 3), device=cuda)),
        dict(packed=packed.float()),
        dict(poses=poses.cpu()),
        dict(tier="rotated"),
        dict(kw=dict(kw, mask_mode="soft")),
    ]
    for change in bad:
        a = dict(tier="target", poses=poses, solve=solve, packed=packed,
                 out=out, kw=kw)
        a.update(change)
        with pytest.raises(ValueError):
            tpe.posed_epilogue(a["tier"], found, invz, a["poses"],
                               a["solve"], a["packed"], _BG, a["out"],
                               **a["kw"])


def _fused_projectors(n, layers, h, w, skew=(0.0, 0.0), cuda=None):
    """n projectors 1 cm apart along x on the card, each one layer or a
    masked 2-layer LDI of the camera's dims."""
    projs = []
    for i in range(n):
        rgb0, disp0, mask0 = _scene(60 + i, h, w)
        extra = []
        if layers > 1:
            rgb1, disp1, mask1 = _scene(80 + i, h, w)
            extra.append(dict(rgb=rgb1, disp=disp1, mask=mask1,
                              focal_px=0.78 * w, invz_min=0.5, invz_max=0.1))
        projs.append(lif_tpu_torch.projector_from_arrays(
            rgb0, disp0, mask0 if layers > 1 else None, focal_px=0.78 * w,
            invz_min=2.0, invz_max=0.6, baseline=1.0,
            position=(0.01 * i - 0.015, 0.0, 0.0), skew=skew, device=cuda,
            extra_layers=extra))
    return projs


def _fused_kernel_against_chain(projs, cams, monkeypatch, **kw):
    """(frames through the fused epilogue kernel, frames through the
    PyTorch chain on the card, fused epilogue launches,
    epilogue.fused.merge count) of one render_fused_fast_batch call."""
    from torch.profiler import ProfilerActivity, profile

    from lif_tpu_torch.ops.cuda import fused_epilogue as tfe
    from lif_tpu_torch.utils import profiling

    before = tfe.fused_epilogue.launches
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = lif_tpu_torch.render_fused_fast_batch(projs, cams, **kw)
        torch.cuda.synchronize()
    merged = profiling.snapshot()["counters"].get("epilogue.fused.merge", 0)
    launches = tfe.fused_epilogue.launches - before
    with monkeypatch.context() as m:
        m.setattr(tfe, "fused_epilogue", tfe.fused_epilogue_plain)
        ref = lif_tpu_torch.render_fused_fast_batch(projs, cams, **kw)
    assert tfe.fused_epilogue.launches - before == launches
    return got, ref, launches, merged


@pytest.mark.parametrize("case", [
    # (projectors, layers, poses, pose_chunk, fuse_tol, to_srgb, skewed, bg)
    (1, 1, 3, 48, 0.05, True, False, "host"),
    (2, 1, 5, 2, 0.0, True, False, "host"),
    (4, 1, 5, 2, 0.05, True, False, "host"),
    (4, 1, 3, 48, 0.0, False, False, "host"),
    (2, 2, 5, 2, 0.05, True, False, "host"),
    (4, 2, 3, 2, 0.0, False, False, "cuda"),
    (4, 1, 4, 3, 0.05, True, True, "host"),
    (2, 2, 3, 48, 0.05, True, True, "cuda"),
    (6, 1, 3, 2, 0.05, True, False, "host"),
    (10, 1, 3, 2, 0.05, True, False, "host"),
    (17, 2, 3, 48, 0.0, False, False, "cuda"),
], ids=["one", "two-hard-chunks", "four-chunks", "four-hard-linear",
        "ldi-chunks", "ldi-four-hard-linear", "four-skewed",
        "ldi-skewed", "six", "ten-chunks", "ldi-seventeen-hard-linear"])
def test_fused_epilogue_kernel_equals_the_chain(cuda, case, monkeypatch):
    """render_fused_fast_batch through the fused epilogue kernel equals the
    same call through the PyTorch chain on the card bit for bit (max |diff|
    0), with one launch and one epilogue.fused.merge count a pose chunk,
    for any number of projectors and layers (past the four projectors
    the kernel keeps in registers, and past the 32 layers its parameters
    hold); LDI projectors take mask 'multiply'."""
    n, layers, poses, chunk, tol, to_srgb, skewed, bg = case
    h, w = 64, 128
    projs = _fused_projectors(n, layers, h, w,
                              (0.021, -0.0137) if skewed else (0.0, 0.0),
                              cuda)
    cams = [lif_tpu_torch.Camera.create(
        w, h, focal_px=0.78 * w, position=[0.004 * i - 0.006, 0.0, 0.0],
        skew=(0.004, 0.0061) if skewed else (0.0, 0.0))
        for i in range(poses)]
    background = torch.tensor(_BG, device=cuda) if bg == "cuda" else _BG
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=chunk,
                                               fuse_tol=tol)
    got, ref, launches, merged = _fused_kernel_against_chain(
        projs, cams, monkeypatch, config=cfg, background=background,
        to_srgb=to_srgb)
    assert launches == merged == len(trenderer._pose_chunks(poses, chunk))
    assert got.shape == ref.shape == (poses, h, w, 4)
    assert 0.0 < float(got[..., 3].mean()) <= 1.0
    assert (got - ref).abs().max().item() == 0.0
    assert torch.equal(got, ref)


def test_fused_epilogue_kernel_at_the_benchmark_shape(cuda, monkeypatch):
    """fusion4k.trajectory's call: four one-layer 3840x2160 projectors 2 cm
    apart, four cameras at fuse_tol 0.05 and sRGB, through the kernel and
    through the chain: max |diff| 0, one launch; the device trace holds
    the kernel and no CatArrayBatchedCopy."""
    from torch.profiler import ProfilerActivity, profile

    h, w = 2160, 3840
    projs = []
    for i in range(4):
        rgb, disp, _ = _scene(90 + i, h, w)
        projs.append(lif_tpu_torch.projector_from_arrays(
            rgb, disp, focal_px=0.78 * w, invz_min=0.09 / 0.045,
            invz_max=0.0001 / 0.045, baseline=0.045,
            position=(0.02 * i, 0.0, 0.0), device=cuda))
    cams = [lif_tpu_torch.Camera.create(
        w, h, focal_px=0.78 * w, position=[0.05 + 0.002 * j, 0.0, 0.0])
        for j in range(4)]
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(fuse_tol=0.05)
    got, ref, launches, merged = _fused_kernel_against_chain(
        projs, cams, monkeypatch, config=cfg)
    assert launches == merged == 1
    assert (got - ref).abs().max().item() == 0.0
    del ref
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lif_tpu_torch.render_fused_fast_batch(projs, cams, config=cfg)
        torch.cuda.synchronize()
    events = prof.key_averages()
    assert any("fused_epilogue_kernel" in e.key for e in events)
    assert not [e for e in events if "CatArrayBatchedCopy" in e.key]


@pytest.mark.parametrize("mask_modes,bg", [
    (("multiply", "none", "hard"), "host"),
    (("hard", "multiply", "none"), "cuda"),
])
@pytest.mark.parametrize("tol", [0.0, 0.05])
def test_fused_epilogue_kernel_on_padded_cropped_entries(cuda, mask_modes,
                                                         bg, tol):
    """The kernel against its plain version on march outputs it is not
    given by the renderer's call: a march width padded past the true width,
    an outpaint crop, x and y offsets and mixed layer counts (2, 1, 3) and
    mask modes, on the card: max |diff| 0 over every pixel of `out`."""
    from lif_tpu_torch.ops.cuda import fused_epilogue as tfe

    b, h, w, w_true = 3, 24, 72, 67
    plan = tsm.translation_plan(w + 8, h + 4, w, h, 6.0, 0.0)
    g = torch.Generator(device="cpu").manual_seed(5)

    def layer(k):
        hit = (torch.rand((b, h, w), generator=g) > 0.3).float()
        invz = torch.rand((b, h, w), generator=g) * 0.8 + 0.1
        invz[:, :, k::7] = 0.55  # ties across projectors
        rgba = torch.rand((b, h, w, 4), generator=g)
        poses = torch.tensor([[0.01 * (k + j), 0.0, 0.0] for j in range(b)])
        return tfe.FusedLayer(hit.to(cuda), invz.to(cuda), rgba.to(cuda),
                              poses.to(cuda), plan, 30.0 + k,
                              (0.75 - 0.5 * k, 0.25 * k), 2 * k)

    layers = [[layer(0), layer(1)], [layer(2)], [layer(3), layer(4),
                                                 layer(5)]]
    views = list(zip(mask_modes, layers))
    background = torch.tensor(_BG, device=cuda) if bg == "cuda" else _BG
    kw = dict(background=background, feathering=0.1, fuse_tol=tol,
              to_srgb=True)
    before = tfe.fused_epilogue.launches
    got = torch.full((b, h, w_true, 4), 7.0, device=cuda)
    ref = torch.empty_like(got)
    tfe.fused_epilogue(views, got, **kw)
    tfe.fused_epilogue_plain(views, ref, **kw)
    torch.cuda.synchronize()
    assert tfe.fused_epilogue.launches == before + 1
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() == 0.0
    assert torch.equal(got, ref)


def test_fused_epilogue_rejects_bad_inputs(cuda):
    """The wrapper raises on what the kernel does not take: a true width
    beyond the march's, a plan of other dims, CPU poses, an unknown mask
    mode, no projector, a projector without a layer."""
    from lif_tpu_torch.ops.cuda import fused_epilogue as tfe

    b, h, w = 2, 16, 32
    plan = tsm.translation_plan(w, h, w, h, 4.0, 0.0)
    lay = tfe.FusedLayer(
        torch.ones((b, h, w), device=cuda),
        torch.full((b, h, w), 0.5, device=cuda),
        torch.rand((b, h, w, 4), device=cuda),
        torch.zeros((b, 3), device=cuda), plan, 30.0)
    kw = dict(background=_BG, feathering=0.1, fuse_tol=0.05, to_srgb=True)
    out = torch.empty((b, h, w, 4), device=cuda)
    tfe.fused_epilogue([("none", [lay])], out, **kw)
    bad = [
        ([("none", [lay])], torch.empty((b, h, w + 8, 4), device=cuda)),
        ([("none", [lay._replace(plan=plan._replace(out_w=w + 8))])], out),
        ([("none", [lay._replace(poses=lay.poses.cpu())])], out),
        ([("soft", [lay])], out),
        ([], out),
        ([("none", [lay]), ("none", [])], out),
    ]
    for views, o in bad:
        with pytest.raises(ValueError):
            tfe.fused_epilogue(views, o, **kw)


def _stereo_pair(layers, h, w, skew=(0.0, 0.0), cuda=None,
                 margins=((16, 32), (8, 16))):
    """Two views at -+0.1 m on the card: one layer each, or masked 3-layer
    LDIs whose back two layers are outpainted by `margins` (rows,
    columns): by default even ones, which the lateral march takes."""
    pair = []
    for seed, x in ((110, -0.1), (120, 0.1)):
        rgb0, disp0, mask0 = _scene(seed, h, w)
        extra = []
        for i, (dh, dw) in enumerate(margins[: layers - 1]):
            rgb, disp, mask = _scene(seed + i + 1, h + dh, w + dw)
            extra.append(dict(rgb=rgb, disp=disp, mask=mask,
                              focal_px=0.78 * w, invz_min=0.5 - 0.1 * i,
                              invz_max=0.1))
        pair.append(lif_tpu_torch.projector_from_arrays(
            rgb0, disp0, mask0 if layers > 1 else None, focal_px=0.78 * w,
            invz_min=2.0, invz_max=0.6, baseline=1.0, position=(x, 0.0, 0.0),
            skew=skew, device=cuda, extra_layers=extra))
    return pair


def _stereo_kernel_against_chain(pair, cams, monkeypatch, **kw):
    """(frames through the stereo epilogue kernel, frames through its
    plain version, the PyTorch chain, on the card, kernel launches, the
    call's counters) of one render_stereo_fast_batch call."""
    from torch.profiler import ProfilerActivity, profile

    from lif_tpu_torch.ops.cuda import stereo_epilogue as tse
    from lif_tpu_torch.utils import profiling

    before = tse.stereo_epilogue.launches
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = lif_tpu_torch.render_stereo_fast_batch(*pair, cams, **kw)
        torch.cuda.synchronize()
    counters = profiling.snapshot()["counters"]
    launches = tse.stereo_epilogue.launches - before
    with monkeypatch.context() as m:
        m.setattr(tse, "stereo_epilogue", tse.stereo_epilogue_plain)
        ref = lif_tpu_torch.render_stereo_fast_batch(*pair, cams, **kw)
        torch.cuda.synchronize()
    assert tse.stereo_epilogue.launches - before == launches
    return got, ref, launches, counters


@pytest.mark.parametrize("case", [
    # (layers, h, w, poses, pose_chunk, to_srgb, skewed, bg)
    (1, 64, 128, 5, 48, True, False, "host"),
    (1, 62, 128, 5, 2, True, False, "cuda"),
    (1, 63, 120, 3, 2, False, False, "host"),
    (3, 64, 128, 5, 2, True, False, "host"),
    (3, 62, 128, 3, 48, False, False, "cuda"),
    (3, 63, 128, 5, 3, True, True, "host"),
], ids=["one-ds4", "one-ds2-chunks", "one-ds1-linear", "ldi-ds4-chunks",
        "ldi-ds2-linear", "ldi-ds1-skewed-chunks"])
def test_stereo_epilogue_kernel_equals_the_chain(cuda, case, monkeypatch):
    """render_stereo_fast_batch through the stereo epilogue kernel equals
    the same call through the PyTorch chain on the card bit for bit (max
    |diff| 0), with one launch, one stereo.blend and one
    epilogue.stereo.fused count a layer of each pose chunk: one layer
    (taper only) and three (outpainted, the hard discard), every
    confidence step (4, 2, 1 at heights 64, 62, 63), cameras left of,
    between and right of the views (blend weights 0, between and 1)."""
    layers, h, w, poses, chunk, to_srgb, skewed, bg = case
    pair = _stereo_pair(layers, h, w,
                        (0.021, -0.0137) if skewed else (0.0, 0.0), cuda)
    xs = [-0.12, -0.04, 0.015, 0.06, 0.13][:poses]
    cams = [lif_tpu_torch.Camera.create(
        w, h, focal_px=0.78 * w, position=[x, 0.0, 0.0],
        skew=(0.004, 0.0061) if skewed else (0.0, 0.0)) for x in xs]
    background = torch.tensor(_BG, device=cuda) if bg == "cuda" else _BG
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=chunk)
    got, ref, launches, counters = _stereo_kernel_against_chain(
        pair, cams, monkeypatch, config=cfg, background=background,
        to_srgb=to_srgb)
    n = len(trenderer._pose_chunks(poses, chunk)) * layers
    assert launches == counters["epilogue.stereo.fused"] == n
    assert counters["stereo.blend"] == n
    assert got.shape == ref.shape == (poses, h, w, 4)
    assert 0.0 < float(got[..., 3].mean()) <= 1.0
    assert (got - ref).abs().max().item() == 0.0
    assert torch.equal(got, ref)


@pytest.mark.parametrize("off,margins", [
    (1, ((17, 33), (8, 16))), (2, ((16, 32), (9, 17)))],
    ids=["middle-off", "back-off"])
def test_stereo_epilogue_mixed_call_equals_the_chain(cuda, off, margins,
                                                     monkeypatch):
    """A lateral LDI call whose layer `off` is outpainted by odd margins,
    so that both eyes take it off the lateral march: the kernel finishes
    the other layers and the chain that one, each reading what the other
    left premultiplied in the frames (a chain layer between two kernel
    layers, or behind them). Bit for bit the same call with every layer
    on the chain, with one launch and epilogue.stereo.fused count per
    march layer of each chunk, and stereo.blend per layer."""
    h, w, poses, chunk = 64, 128, 5, 2
    pair = _stereo_pair(3, h, w, cuda=cuda, margins=margins)
    cams = [lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                        position=[x, 0.0, 0.0])
            for x in (-0.12, -0.04, 0.015, 0.06, 0.13)]
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=chunk)
    tiers = trenderer.render_stereo_fast_batch(*pair, cams, config=cfg,
                                               return_tiers=True)[1]
    assert tiers[0] == tiers[1]
    assert [t == "march" for t in tiers[0]] == [i != off for i in range(3)]
    got, ref, launches, counters = _stereo_kernel_against_chain(
        pair, cams, monkeypatch, config=cfg, background=_BG)
    chunks = len(trenderer._pose_chunks(poses, chunk))
    assert launches == counters["epilogue.stereo.fused"] == 2 * chunks
    assert counters["stereo.blend"] == 3 * chunks
    assert 0.0 < float(got[..., 3].mean()) <= 1.0
    assert (got - ref).abs().max().item() == 0.0
    assert torch.equal(got, ref)


def test_stereo_epilogue_kernel_at_the_cell_shape(cuda, monkeypatch):
    """One call of the benchmark's stereo cell (sfmoma.stereo: 96 cameras
    over two 3-layer views of 1408x928 layers, two pose chunks of 48)
    through the kernel and through the chain on the card: the check's
    numbers (max_gap, mean_gap, mismatch_share) 0, within the cell's
    limits; a traced call counts 6 epilogue.stereo.fused and 6
    stereo.blend (3 layers x 2 chunks), with 6 launches; the device trace
    holds the kernel and no CatArrayBatchedCopy."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    from benchmark.lifbench import check, harness, parts, traffic

    cell = harness.Cell(Path(__file__).resolve().parents[1], "sfmoma.stereo")
    scene = parts.load("scenes", cell.config["scene"])
    srcs = scene.build(cell.config, 2**31 + 2509, cuda)
    projs = scene.projectors(lif_tpu_torch, srcs, cell.config)
    poses = traffic.PoseStream(cell.traffic,
                               np.random.default_rng(2509)).next()
    cams = traffic.cameras(lif_tpu_torch, poses, cell.config)
    cfg = lif_tpu_torch.RenderConfig(**cell.config["render_config"])
    got, ref, launches, counters = _stereo_kernel_against_chain(
        projs, cams, monkeypatch, config=cfg)
    assert got.shape == (96, 800, 1280, 4)
    assert launches == counters["epilogue.stereo.fused"] == 6
    assert counters["stereo.blend"] == 6
    numbers = check.gaps(list(zip(got, ref)))
    ok, rows = check.judge(numbers, cell.check["limits"])
    assert ok, rows
    assert numbers == {"max_gap": 0.0, "mean_gap": 0.0,
                       "mismatch_share": 0.0}
    del ref
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        lif_tpu_torch.render_stereo_fast_batch(*projs, cams, config=cfg)
        torch.cuda.synchronize()
    events = prof.key_averages()
    assert any("stereo_epilogue_kernel" in e.key for e in events)
    assert not [e for e in events if "CatArrayBatchedCopy" in e.key]


def test_stereo_epilogue_rejects_bad_inputs(cuda):
    """The wrapper raises on what the kernel does not take: one eye, a
    march of another width than the output (a width pad), CPU poses,
    transforms of another shape, a disparity texture whose rows are not
    contiguous, weights of another length, an unknown mask mode; it takes
    a texture with padded rows."""
    from lif_tpu_torch.ops.cuda import stereo_epilogue as tse

    b, h, w = 2, 16, 32
    plan = tsm.translation_plan(w, h, w, h, 4.0, 0.0)
    eye = tse.StereoEye(
        torch.ones((b, h, w), device=cuda),
        torch.full((b, h, w), 0.5, device=cuda),
        torch.rand((b, h, w, 4), device=cuda),
        torch.zeros((b, 3), device=cuda), plan, 30.0, (0.0, 0.0), 0,
        torch.rand((h, w), device=cuda), 2.0, 0.6,
        torch.rand((b, 12), device=cuda))
    w_r = torch.full((b,), 0.5, device=cuda)
    kw = dict(background=_BG, feathering=0.1, mask_mode="none",
              to_srgb=True)
    out = torch.empty((b, h, w, 4), device=cuda)
    tse.stereo_epilogue([eye, eye], w_r, out, **kw)
    padded = eye._replace(disp=torch.rand((h, w + 8), device=cuda)[:, :w])
    tse.stereo_epilogue([eye, padded], w_r, out, **kw)
    wide = eye._replace(plan=plan._replace(out_w=w + 8))
    bad = [
        ([eye], w_r, out, kw),
        ([eye, wide], w_r, out, kw),
        ([eye, eye._replace(poses=eye.poses.cpu())], w_r, out, kw),
        ([eye, eye._replace(transforms=eye.transforms[:, :9].contiguous())],
         w_r, out, kw),
        ([eye, eye._replace(disp=eye.disp.t())], w_r, out, kw),
        ([eye, eye], w_r[:1], out, kw),
        ([eye, eye], w_r, out, dict(kw, mask_mode="soft")),
    ]
    for eyes, weights, o, args in bad:
        with pytest.raises(ValueError):
            tse.stereo_epilogue(eyes, weights, o, **args)
