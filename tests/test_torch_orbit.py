"""The port's orbit path end to end against lif_tpu (CPU).

The same seeded scene goes through lif_tpu.render_fast_batch (JAX on the
CPU: its XLA twin of the target-ray march) and, carried across with
projector_from_reference, through lif_tpu_torch.render_fast_batch (the
plain twin on CPU tensors). Yaw-family batches route to the 'target'
tier, pitch-family batches to it through the x<->y transpose; the
batches lif_tpu sends to its two-phase 'rotated' tier and to its plane
sweep are checked in tests/test_torch_rotated.py. Gate: >= 60 dB and
fewer than 0.1% of
pixels off by more than 1e-3 (tests/test_sweep_target.py:146-153; XLA's
FMA contraction can flip isolated grazing crossings).
"""

import numpy as np
import pytest
import torch

import lif_tpu
import lif_tpu_torch
from lif_tpu_torch.models import renderer as trenderer
from lif_tpu_torch.ops import sweep_target as tst

from .scenes import make_layer, smooth_noise
from .test_rotated_march import _rotx, _roty

torch.set_num_threads(1)

IZMIN, IZMAX = 2.0, 0.1


def _scene(rng, h, w):
    """Smooth noise plus a hard near box (tests/test_torch_render.py)."""
    disp = smooth_noise(rng, h, w, octaves=3, lo=0.3, hi=0.8).astype(
        np.float32)
    disp[h // 3 : h // 2, w // 3 : w // 2] = 0.95
    rgb = np.stack([smooth_noise(rng, h, w, octaves=4) for _ in range(3)],
                   -1).astype(np.float32)
    return rgb, disp


def _projectors(rng, h=96, w=128, **kw):
    rgb, disp = _scene(rng, h, w)
    jp = lif_tpu.projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=IZMIN, invz_max=IZMAX,
        baseline=1.0, **kw,
    )
    return jp, lif_tpu_torch.projector_from_reference(jp, device="cpu")


def _cams(pkg, w, h, poses):
    return [pkg.Camera.create(w, h, focal_px=0.78 * w, position=c,
                              rotation=r) for r, c in poses]


def _psnr(a, b):
    mse = np.mean((a[..., :3] - b[..., :3]) ** 2)
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def _assert_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    assert _psnr(got, ref) >= 60.0
    assert (np.abs(got - ref).max(-1) > 1e-3).mean() < 1e-3


def _both(jp, tp, w, h, poses, **kw):
    ref, jt = lif_tpu.render_fast_batch(
        jp, _cams(lif_tpu, w, h, poses), return_tiers=True, **kw)
    got, tt = lif_tpu_torch.render_fast_batch(
        tp, _cams(lif_tpu_torch, w, h, poses), return_tiers=True, **kw)
    return np.asarray(ref), tuple(jt), got, tuple(tt)


_YAW3 = [(_roty(-6.0), [-0.1, 0.0, 0.01]), (_roty(0.0), [0.0, 0.0, 0.0]),
         (_roty(8.0), [0.15, 0.0, -0.01])]


@pytest.mark.parametrize("to_srgb", [False, True])
def test_yaw_orbit_matches_lif_tpu(rng, to_srgb):
    """A yaw orbit batch of 3 poses routes 'target' in both packages and
    renders the same image."""
    jp, tp = _projectors(rng)
    bg = (0.1, 0.2, 0.3, 1.0)
    ref, jt, got, tt = _both(jp, tp, 128, 96, _YAW3, to_srgb=to_srgb,
                             background=bg)
    assert jt == tt == ("target",)
    assert got.shape == (3, 96, 128, 4) and got.device.type == "cpu"
    _assert_close(got, ref)


def test_orbit_pose_family_routes_target(rng):
    """Poses from orbit_pose (the demo's orbit controls) about a point in
    front of the projector: a yaw orbit on the 'target' tier."""
    jp, tp = _projectors(rng)
    poses = [lif_tpu_torch.orbit_pose([0.0, 0.0, -1.0], 1.0, np.deg2rad(t))
             for t in (-4.0, 1.0, 6.0)]
    ref, jt, got, tt = _both(jp, tp, 128, 96, [(r, p) for p, r in poses])
    assert jt == tt == ("target",)
    _assert_close(got, ref)


@pytest.mark.parametrize("h,poses", [
    (112, [(_rotx(6.0), [0.1, 0.0, 0.0]), (_rotx(-4.0), [0.0, 0.05, 0.0])]),
    (96, [(_rotx(5.0), [0.0, 0.08, -0.02])]),
])
def test_pitch_routes_transposed_target(rng, monkeypatch, h, poses):
    """Pitch poses fail the yaw gate upright and ride the target tier
    transposed (h=112: transposed width 128 with a symmetric 16-px pad;
    h=96: 32-px pad); same image as lif_tpu."""
    jp, tp = _projectors(rng, h=h)
    calls = []
    orig = trenderer._transposed_projector
    monkeypatch.setattr(trenderer, "_transposed_projector",
                        lambda p: (calls.append(1), orig(p))[1])
    ref, jt, got, tt = _both(jp, tp, 128, h, poses)
    assert jt == tt == ("target",)
    assert calls, "the pitch batch must take the transposed route"
    assert got.shape == (len(poses), h, 128, 4) and got.is_contiguous()
    _assert_close(got, ref)


def test_combined_yaw_pitch_raises_rotated(rng):
    """A pose rotated about both axes fails the yaw gate in both
    orientations: lif_tpu routes it 'rotated', and so does the port, with
    the same image. (Before the two-phase tier was ported the port raised
    naming it; the name is kept.)"""
    jp, tp = _projectors(rng, h=112)
    poses = [(_rotx(5.0) @ _roty(5.0), [0.1, 0.0, 0.0])]
    ref, jt, got, tt = _both(jp, tp, 128, 112, poses)
    assert jt == tt == ("rotated",)
    _assert_close(got, ref)


@pytest.mark.parametrize("case", ["unrotated_y", "skewed_yaw", "width_96"])
def test_uncovered_batches_raise_the_tier_lif_tpu_picks(rng, case):
    """Unrotated y/z translations route 'scaled'; skewed yaw batches and
    yaw batches at widths the target planner rejects route 'rotated' —
    in both packages, with the same image. (These raised naming the tier
    before the port had it; the name is kept.)"""
    w, h = (96, 96) if case == "width_96" else (128, 96)
    jp, tp = _projectors(rng, h=h, w=w)
    skew = (0.02, 0.0) if case == "skewed_yaw" else (0.0, 0.0)
    pose = ((np.eye(3), [0.0, 0.05, 0.0]) if case == "unrotated_y"
            else (_roty(4.0), [0.05, 0.0, 0.0]))

    def cams(pkg):
        return [pkg.Camera.create(w, h, focal_px=0.78 * w, position=pose[1],
                                  rotation=pose[0], skew=skew)]

    ref, jt = lif_tpu.render_fast_batch(jp, cams(lif_tpu), return_tiers=True)
    got, tt = lif_tpu_torch.render_fast_batch(tp, cams(lif_tpu_torch),
                                              return_tiers=True)
    tier = "scaled" if case == "unrotated_y" else "rotated"
    assert tuple(jt) == tt == (tier,)
    _assert_close(got, np.asarray(ref))


def test_pose_chunked_equals_unchunked(rng):
    """Pose chunks are a batching detail (tests/test_sweep_target.py:
    377-405): 5 poses in chunks of 2 equal the whole batch to 1e-5, and
    lif_tpu's chunked render."""
    jp, tp = _projectors(rng)
    poses = [(_roty(3.0 * i - 6.0), [0.05 * i - 0.1, 0.0, 0.0])
             for i in range(5)]
    cams = _cams(lif_tpu_torch, 128, 96, poses)
    big = lif_tpu_torch.render_fast_batch(
        tp, cams, config=lif_tpu_torch.RenderConfig(pose_chunk=0))
    small = lif_tpu_torch.render_fast_batch(
        tp, cams, config=lif_tpu_torch.RenderConfig(pose_chunk=2))
    np.testing.assert_allclose(big.numpy(), small.numpy(), atol=1e-5)
    ref = lif_tpu.render_fast_batch(
        jp, _cams(lif_tpu, 128, 96, poses),
        config=lif_tpu.RenderConfig(pose_chunk=2))
    _assert_close(small, ref)


def test_two_layer_ldi_orbit(rng):
    """Two LDI layers, the back one outpainted (taller and wider; the
    target tier plans each layer with its own source dims), with a
    front mask: both layers 'target', same front-to-back composite."""
    h, w = 96, 128
    rgb0, disp0 = _scene(rng, h, w)
    back = make_layer(rng, h + 16, w + 32, invz_min=0.5, invz_max=0.1)
    mask0 = (smooth_noise(rng, h, w, octaves=2) > 0.35).astype(np.float32)
    jp = lif_tpu.projector_from_arrays(
        rgb0, disp0, mask0, focal_px=0.78 * w, invz_min=2.0, invz_max=0.6,
        baseline=1.0,
        extra_layers=[dict(rgb=back["rgb"], disp=back["disp"],
                           focal_px=0.78 * w, invz_min=0.5, invz_max=0.1)],
    )
    tp = lif_tpu_torch.projector_from_reference(jp, device="cpu")
    ref, jt, got, tt = _both(jp, tp, w, h, _YAW3[::2], to_srgb=False)
    assert jt == tt == ("target", "target")
    _assert_close(got, ref)


@pytest.mark.parametrize(
    "rot", [_roty(8.0), _rotx(6.0), _rotx(5.0) @ _roty(5.0)],
    ids=["yaw", "pitch", "yaw_pitch"],
)
def test_exact_march_and_camera_match_at_rotated_poses(rng, rot):
    """The modules the orbit path builds on, held to lif_tpu at rotated
    poses: Camera.create(rotation=...) stores the same fields, and the
    exact march (the fidelity oracle) renders the same image."""
    jp, tp = _projectors(rng)
    (jc,), (tc,) = (_cams(pkg, 128, 96, [(rot, [0.1, 0.02, -0.01])])
                    for pkg in (lif_tpu, lif_tpu_torch))
    for f in ("position", "rotation", "focal_px", "skew"):
        assert np.array_equal(np.asarray(getattr(jc, f)), getattr(tc, f)), f
    ref = lif_tpu.render_mono_view(jp, jc, mask_mode="none", num_steps=160)
    got = lif_tpu_torch.render_mono_view(tp, tc, mask_mode="none",
                                         num_steps=160)
    _assert_close(got, ref)


def test_orbit_quality_against_exact_march(rng):
    """March-class fidelity through the public API: >= 40 dB against the
    port's own 1280-step exact march (tests/test_sweep_target.py:
    263-296)."""
    h, w = 112, 128
    _, tp = _projectors(rng, h=h, w=w)
    cam = _cams(lif_tpu_torch, w, h, [(_roty(8.0), [0.15, 0.0, -0.01])])
    out, tiers = lif_tpu_torch.render_fast_batch(tp, cam, return_tiers=True)
    assert tiers == ("target",)
    ref = lif_tpu_torch.render_mono_view(tp, cam[0], mask_mode="none",
                                         num_steps=1280)
    sl = np.s_[10:-10, 10:-10]
    assert _psnr(out[0].numpy()[sl], ref.numpy()[sl]) >= 40.0


def test_target_plan_caches(rng, monkeypatch):
    """A replayed pose batch hits the exact-batch plan cache (no
    re-planning); an ineligible batch is cached as such; the transposed
    projector is built once and rebuilt after an in-place texture
    write."""
    _, tp = _projectors(rng, h=112)
    cams = _cams(lif_tpu_torch, 128, 112, _YAW3)
    calls = []
    orig = tst.target_extents
    monkeypatch.setattr(tst, "target_extents",
                        lambda *a, **k: (calls.append(1), orig(*a, **k))[1])
    a = lif_tpu_torch.render_fast_batch(tp, cams)
    n = len(calls)
    b = lif_tpu_torch.render_fast_batch(tp, cams)
    assert len(calls) == n and torch.equal(a, b)
    pitch = _cams(lif_tpu_torch, 128, 112, [(_rotx(6.0), [0.1, 0.0, 0.0])])
    lif_tpu_torch.render_fast_batch(tp, pitch)
    assert "ineligible" in trenderer._TARGET_PLAN_CACHE.values()
    t1 = trenderer._transposed_projector(tp)
    assert trenderer._transposed_projector(tp) is t1
    assert torch.equal(t1.disp, tp.disp.transpose(1, 2))
    tp.disp.mul_(0.5)
    t2 = trenderer._transposed_projector(tp)
    assert t2 is not t1 and torch.equal(t2.disp, tp.disp.transpose(1, 2))
