"""The port's two-phase rotated tier and the new routing of
render_fast_batch against lif_tpu (CPU).

The same numpy inputs go through lif_tpu (JAX on the CPU: phase A on its
XLA twin of the scaled march) and lif_tpu_torch (the plain twin on CPU
tensors). Host planning (intermediate_extent, plan_rotated) must be EQUAL,
including which batches raise ValueError. Images are held to >= 60 dB
against lif_tpu's frame, the gate of tests/test_torch_orbit.py (phase A's
grazing crossings may flip at isolated pixels under XLA's FMA
contraction, which moves a bracket there, not the image). Through
render_fast_batch the per-layer tiers must equal lif_tpu's.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lif_tpu
import lif_tpu_torch
from lif_tpu.ops import rotated_march as jrm
from lif_tpu_torch.models import renderer as trenderer
from lif_tpu_torch.ops import rotated_march as trm

from .scenes import make_layer, smooth_noise
from .test_rotated_march import _rotx, _roty, _rotz
from .test_sweep_march import _psnr, _scene
from .test_torch_orbit import _assert_close, _both, _projectors

torch.set_num_threads(1)

IZMIN, IZMAX = 2.0, 0.1

# tests/test_rotated_march.py:83-103, plus a skewed case
_FAMILIES = {
    "yaw_lateral": ([0.04, 0.0, 0.0], _roty(4.0), 1.0, None),
    "general": ([0.03, 0.01, 0.02], _roty(3.0) @ _rotx(2.0), 1.0, None),
    "pure_rotation": ([0.0, 0.0, 0.0], _roty(6.0), 1.0, None),
    "pure_zoom": ([0.0, 0.0, 0.0], np.eye(3), 1.1, None),
    "rot_zoom": ([0.03, 0.0, 0.0], _roty(3.0), 1.06, None),
    "roll_lateral": ([0.05, 0.0, 0.0], _rotz(10.0), 1.0, None),
    "roll_yaw_pitch": ([0.02, 0.01, 0.0], _rotz(12.0) @ _roty(8.0)
                       @ _rotx(5.0), 1.0, None),
    "skewed": ([0.03, 0.01, 0.02], _roty(3.0) @ _rotx(2.0), 1.0,
               ((0.02, -0.01), (-0.01, 0.015))),
}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _plans(family, h=96, w=128, n=1):
    c1, rot, fr, sk = _FAMILIES[family]
    sk1, sk2 = sk or ((0.0, 0.0), (0.0, 0.0))
    rots = [rot @ _roty(1.5 * i) for i in range(n)]
    c1s = [np.asarray(c1) * (1.0 - 0.3 * i) for i in range(n)]
    f1 = 0.78 * w
    args = (w, h, w, h, f1, f1 / fr, rots, c1s, IZMIN, IZMAX)
    kw = dict(step_px=0.75, sk1=sk1, sk2=sk2)
    return rots, c1s, f1, fr, sk1, sk2, jrm.plan_rotated(*args, **kw), \
        trm.plan_rotated(*args, **kw)


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_planning_equal(family):
    """intermediate_extent and plan_rotated: equal extents, aligned poses,
    scaled plans, ladders and skip decisions."""
    rots, _, f1, fr, sk1, sk2, pa, pb = _plans(family, n=3)
    for guard in (16.0, 4.0):
        assert jrm.intermediate_extent(
            rots, f1, f1 / fr, 128, 96, guard_px=guard, sk1=sk1, sk2=sk2
        ) == trm.intermediate_extent(
            rots, f1, f1 / fr, 128, 96, guard_px=guard, sk1=sk1, sk2=sk2)
    assert (pa[0] is None) == (pb[0] is None)
    if pa[0] is not None:
        assert tuple(pa[0]) == tuple(pb[0])
        assert np.array_equal(pa[4], pb[4])
    assert pa[1:3] == pb[1:3] and pa[5:] == pb[5:]
    assert np.array_equal(pa[3], pb[3])


def test_plan_rejections_equal():
    """A rotation too large for the intermediate extent raises the same
    ValueError in both packages."""
    args = (128, 96, 128, 96, 100.0, 100.0, [_roty(70.0)], [np.zeros(3)],
            IZMIN, IZMAX)
    with pytest.raises(ValueError) as ja:
        jrm.plan_rotated(*args)
    with pytest.raises(ValueError) as tb:
        trm.plan_rotated(*args)
    assert str(ja.value) == str(tb.value)


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_two_phase_matches_lif_tpu(rng, family):
    """render_rotated_march_batch against lif_tpu's on the seven pose
    families of tests/test_rotated_march.py (pure rotation and pure zoom
    skip phase A) and a skewed one, at refine 2."""
    rots, c1s, f1, fr, sk1, sk2, pa, pb = _plans(family)
    _, wi, hi, aligned, grids, k, skip = pa
    rgb, disp, mask = _scene(rng, h=96, w=128)
    args = (IZMIN, IZMAX, f1, np.asarray(c1s, np.float32),
            np.asarray(rots, np.float32), np.asarray(aligned, np.float32),
            f1 / fr)
    grids = np.zeros((1, 1), np.float32) if skip else grids
    kw = dict(mask_mode="none", refine=2, skip_phase_a=skip, sk1=sk1,
              sk2=sk2, to_srgb=False)
    ref = jrm.render_rotated_march_batch(
        rgb, disp, mask, *args, jnp.asarray(grids), jnp.zeros(4), pa[0],
        max(k, 1), 128, 96, wi, hi, **kw)
    got = trm.render_rotated_march_batch(
        *_t(rgb, disp, mask), *args, grids, np.zeros(4, np.float32), pb[0],
        max(k, 1), 128, 96, wi, hi, **kw)
    assert got.shape == (1, 96, 128, 4)
    assert _psnr(got.numpy(), np.asarray(ref)) >= 60.0


def test_raw_and_batch_equal_per_pose(rng):
    """Three poses batched equal each pose alone (exactly), and the raw
    tuple matches lif_tpu's with mask_mode multiply."""
    rots, c1s, f1, fr, sk1, sk2, pa, pb = _plans("general", n=3)
    plan, wi, hi, aligned, grids, k, skip = pb
    assert not skip
    rgb, disp, mask = _scene(rng, h=96, w=128)
    mask = (rng.random(mask.shape) > 0.15).astype(np.float32)
    tex = _t(rgb, disp, mask)

    def run(sl, pkg_fn, texs, g, p, **kw):
        return pkg_fn(*texs, IZMIN, IZMAX, f1, np.asarray(c1s, np.float32)[sl],
                      np.asarray(rots, np.float32)[sl],
                      np.asarray(aligned, np.float32)[sl], f1, g[sl],
                      np.zeros(4, np.float32), p, k, 128, 96, wi, hi,
                      mask_mode="multiply", **kw)

    whole = run(slice(None), trm.render_rotated_march_batch, tex, grids, plan)
    for i in range(3):
        one = run(slice(i, i + 1), trm.render_rotated_march_batch, tex, grids,
                  plan)
        assert torch.equal(one[0], whole[i])
    ref = run(slice(None), jrm.render_rotated_march_batch,
              (rgb, disp, mask), jnp.asarray(grids), pa[0], raw=True)
    got = run(slice(None), trm.render_rotated_march_batch, tex, grids, plan,
              raw=True)
    # phase A's ulp-level differences move each bracket's march points a
    # little, which moves invz* by up to the march's last step at a few
    # percent of pixels (the bracket march itself is equal on equal
    # inputs: test_bracket_march_and_corner_quad_equal); the image gate
    # holds for what a caller composites
    rgba, alpha, hit, invz = (np.asarray(a) for a in ref)
    assert np.array_equal(hit, got[2].numpy())
    assert _psnr(got[0].numpy(), rgba) >= 60.0
    assert _psnr(got[1].numpy()[..., None], alpha[..., None]) >= 60.0
    assert np.median(np.abs(invz - got[3].numpy())) < 1e-5


def test_bracket_march_and_corner_quad_equal(rng):
    """Phase B's modules on the same inputs: _bracket_march equals
    lif_tpu's exactly; the four direct corner gathers equal lif_tpu's
    edge-replicated patch-table quad, off the map's edges too."""
    from lif_tpu.ops.sampling import _patch_table

    rgb, disp, mask = _scene(rng, h=96, w=128)
    b, h, w = 2, 40, 50
    qx, qy = rng.uniform(-0.6, 0.6, (2, b, h, w)).astype(np.float32)
    den = rng.uniform(0.9, 1.1, (b, h, w)).astype(np.float32)
    c_vec = rng.uniform(-0.05, 0.05, (b, 3)).astype(np.float32)
    quad = rng.uniform(0.2, 1.9, (b, h, w, 4)).astype(np.float32)
    quad[0, :5] = 0.0  # all corners missed
    quad[1, :3, :, 1] = 0.0  # one corner missed
    izmin, izmax = np.float32(IZMIN), np.float32(IZMAX)
    ref = jrm._bracket_march(
        jnp.asarray(disp), *map(jnp.asarray, (qx, qy, den, c_vec, quad)),
        jnp.float32(izmin), jnp.float32(izmax), 128, 96, 10, False)
    got = trm._bracket_march(torch.from_numpy(disp),
                             *_t(qx, qy, den, c_vec, quad), izmin, izmax,
                             128, 96, 10)
    assert np.array_equal(np.asarray(ref[0]), got[0].numpy())
    assert np.array_equal(np.asarray(ref[1]), got[1].numpy())

    izmaps = rng.uniform(0.0, 2.0, (b, 24, 32)).astype(np.float32)
    u, v = rng.uniform(-0.1, 1.1, (2, b, h, w)).astype(np.float32)
    ix = np.clip(np.floor(u * 32 - 0.5).astype(np.int64), 0, 31)
    iy = np.clip(np.floor(v * 24 - 0.5).astype(np.int64), 0, 23)
    table = np.stack([np.asarray(_patch_table(jnp.asarray(m)))
                      for m in izmaps])  # (B, 24*32, 4)
    want = np.take_along_axis(
        table, (iy * 32 + ix).reshape(b, -1, 1), axis=1).reshape(b, h, w, 4)
    got = trm._corner_quad(torch.from_numpy(izmaps), *_t(u, v))
    assert np.array_equal(want, got.numpy())


# ---------------------------------------------------------------------------
# render_fast_batch: routing and frames equal to lif_tpu's
# ---------------------------------------------------------------------------


def _dolly(n):
    t = np.linspace(0.0, 1.0, n)
    z = np.linspace(-0.05, 0.05, n)
    return [(np.eye(3), [0.03 * np.cos(2 * np.pi * a),
                         0.02 * np.sin(2 * np.pi * a), b])
            for a, b in zip(t, z)]


def test_dolly_batch_routes_scaled(rng):
    """An unrotated dolly batch (the chip drive's family): 'scaled' in
    both packages, same frames."""
    jp, tp = _projectors(rng)
    ref, jt, got, tt = _both(jp, tp, 128, 96, _dolly(5))
    assert jt == tt == ("scaled",)
    _assert_close(got, ref)


def test_mismatched_focal_lateral_layer_routes_scaled(rng):
    """A lateral batch whose camera focal differs from the layer's: the
    layer is not march-eligible and goes through the non-lateral cascade
    to 'scaled', as in lif_tpu."""
    jp, tp = _projectors(rng)
    poses = [(np.eye(3), [x, 0.0, 0.0]) for x in (0.02, 0.05)]
    ref = lif_tpu.render_fast_batch(jp, [lif_tpu.Camera.create(
        128, 96, focal_px=0.9 * 128, position=p) for _, p in poses],
        return_tiers=True)
    got = lif_tpu_torch.render_fast_batch(tp, [lif_tpu_torch.Camera.create(
        128, 96, focal_px=0.9 * 128, position=p) for _, p in poses],
        return_tiers=True)
    assert tuple(ref[1]) == got[1] == ("scaled",)
    _assert_close(got[0], np.asarray(ref[0]))


@pytest.mark.parametrize("rotated", [False, True])
def test_odd_width_pad(rng, rotated):
    """Width 127: an unrotated non-lateral batch renders the padded band
    on 'scaled' (the pad's shift through dx_user) and slices the true
    width; a rotated one drops the pad on 'rotated'."""
    jp, tp = _projectors(rng, h=96, w=127)
    rot = _roty(3.0) if rotated else np.eye(3)
    ref, jt, got, tt = _both(jp, tp, 127, 96, [(rot, [0.03, 0.01, 0.02])])
    assert jt == tt == (("rotated",) if rotated else ("scaled",))
    assert got.shape == (1, 96, 127, 4)
    _assert_close(got, ref)


@pytest.mark.parametrize("case", ["yaw_pitch", "skewed_yaw"])
def test_rotated_batches_route_rotated(rng, case):
    """Combined yaw+pitch (the yaw gate fails upright and transposed) and
    a skewed yaw batch (the target tier skips skew): 'rotated' in both
    packages, same frames."""
    skew = (0.02, -0.01) if case == "skewed_yaw" else (0.0, 0.0)
    jp, tp = _projectors(rng, h=112, skew=skew)
    poses = ([(_rotx(3.0) @ _roty(4.0), [0.05, 0.01, 0.0]),
              (_rotx(-2.0) @ _roty(-3.0), [-0.04, 0.0, 0.01])]
             if case == "yaw_pitch" else [(_roty(4.0), [0.05, 0.0, 0.0])])
    ref, jt, got, tt = _both(jp, tp, 128, 112, poses)
    assert jt == tt == ("rotated",)
    _assert_close(got, ref)


@pytest.mark.parametrize("tier", ["scaled", "rotated"])
def test_two_layer_ldi(rng, tier):
    """Two LDI layers, the back one outpainted, with a front mask: both
    layers on the new tier, same front-to-back composite."""
    h, w = 96, 128
    rgb0 = np.stack([smooth_noise(rng, h, w, octaves=4) for _ in range(3)],
                    -1).astype(np.float32)
    disp0 = smooth_noise(rng, h, w, octaves=3, lo=0.3, hi=0.8).astype(
        np.float32)
    back = make_layer(rng, h + 16, w + 32, invz_min=0.5, invz_max=0.1)
    mask0 = (smooth_noise(rng, h, w, octaves=2) > 0.35).astype(np.float32)
    jp = lif_tpu.projector_from_arrays(
        rgb0, disp0, mask0, focal_px=0.78 * w, invz_min=2.0, invz_max=0.6,
        baseline=1.0,
        extra_layers=[dict(rgb=back["rgb"], disp=back["disp"],
                           focal_px=0.78 * w, invz_min=0.5, invz_max=0.1)],
    )
    tp = lif_tpu_torch.projector_from_reference(jp, device="cpu")
    poses = (_dolly(3) if tier == "scaled"
             else [(_rotx(3.0) @ _roty(4.0), [0.05, 0.01, 0.0])])
    ref, jt, got, tt = _both(jp, tp, w, h, poses, to_srgb=False)
    assert jt == tt == (tier, tier)
    _assert_close(got, ref)


@pytest.mark.parametrize("tier", ["scaled", "rotated"])
def test_pose_chunked_equals_unchunked(rng, tier):
    """Five poses in balanced chunks of at most 2 equal the whole batch
    and lif_tpu's chunked render."""
    jp, tp = _projectors(rng)
    poses = (_dolly(5) if tier == "scaled" else
             [(_rotx(1.0 + 0.5 * i) @ _roty(3.0 - i), [0.02 * i, 0.01, 0.0])
              for i in range(5)])
    cams = [lif_tpu_torch.Camera.create(128, 96, focal_px=0.78 * 128,
                                        position=c, rotation=r)
            for r, c in poses]
    big, tiers = lif_tpu_torch.render_fast_batch(
        tp, cams, config=lif_tpu_torch.RenderConfig(pose_chunk=0),
        return_tiers=True)
    small = lif_tpu_torch.render_fast_batch(
        tp, cams, config=lif_tpu_torch.RenderConfig(pose_chunk=2))
    assert tiers == (tier,)
    np.testing.assert_allclose(big.numpy(), small.numpy(), atol=1e-5)
    ref = lif_tpu.render_fast_batch(
        jp, [lif_tpu.Camera.create(128, 96, focal_px=0.78 * 128, position=c,
                                   rotation=r) for r, c in poses],
        config=lif_tpu.RenderConfig(pose_chunk=2))
    _assert_close(small, ref)


def test_transpose_when_upright_cascade_ends_in_sweep(rng, monkeypatch):
    """A pitch batch whose upright cascade ends in 'sweep' (plan_rotated
    overflows its y budget) takes the transposed target route, as in
    lif_tpu (renderer.py:1243-1250 tries it for 'rotated' OR 'sweep')."""
    jp, tp = _projectors(rng, h=112)
    poses = [(_rotx(12.0), [0.0, 1.0, 0.0]), (_rotx(-12.0), [0.0, -1.0, 0.0])]
    _, jt_up = lif_tpu.render_fast_batch(
        jp, [lif_tpu.Camera.create(128, 112, focal_px=0.78 * 128, position=c,
                                   rotation=r) for r, c in poses],
        return_tiers=True, _transpose=False)
    assert tuple(jt_up) == ("sweep",)
    calls = []
    orig = trenderer._transposed_projector
    monkeypatch.setattr(trenderer, "_transposed_projector",
                        lambda p: (calls.append(1), orig(p))[1])
    ref, jt, got, tt = _both(jp, tp, 128, 112, poses)
    assert jt == tt == ("target",)
    assert calls, "the batch must take the transposed route"
    _assert_close(got, ref)


def test_sweep_batch_raises_naming_sweep(rng):
    """Batches no march tier covers in either orientation: lif_tpu routes
    them to its sweep fallback (render_rotated, after the transposed route
    fails too) and raises TierFallbackWarning naming the plane sweep; the
    port raises the same warning, routes the same tier and renders
    lif_tpu's image. The first pose (1 m off axis) sees nothing; the
    second (30 deg yaw + pitch, 0.1 m) covers about a sixth of the frame.
    Gate: max abs < 2e-3 (the sweep's gate,
    tests/test_torch_render.py::test_sweep_poses_match_lif_tpu)."""
    jp, tp = _projectors(rng)
    for rot, pos, coverage in ((_rotx(12.0) @ _roty(12.0), [0.0, 1.0, 0.0],
                                0.0),
                               (_rotx(30.0) @ _roty(30.0), [0.0, 0.1, 0.0],
                                0.15)):
        fired, outs = [], []
        for pkg, proj in ((lif_tpu, jp), (lif_tpu_torch, tp)):
            cam = pkg.Camera.create(128, 96, focal_px=0.78 * 128,
                                    position=pos, rotation=rot)
            with pytest.warns(UserWarning, match="plane-sweep") as rec:
                out, tiers = pkg.render_fast_batch(proj, [cam],
                                                   return_tiers=True)
            assert tuple(tiers) == ("sweep",)
            fired.append([str(r.message) for r in rec
                          if r.category.__name__ == "TierFallbackWarning"])
            outs.append(np.asarray(out))
        assert fired[0] == fired[1] and fired[0]
        ref, got = outs
        assert np.abs(got - ref).max() < 2e-3
        assert (ref[..., 3] > 0).mean() >= coverage


@pytest.mark.parametrize("case", ["lateral", "dolly", "yaw", "yaw_pitch"])
def test_plan_tiers_is_the_plan_render_fast_batch_renders(rng, case):
    """plan_tiers (what chip_smoke.py plans its kernel checks with) gives
    the tiers render_fast_batch reports, and the scaled march tables of
    its 'scaled' and 'rotated' setups have the planned shapes."""
    from lif_tpu_torch.ops import sweep_scaled as tss

    _, tp = _projectors(rng, h=112)
    poses = {
        "lateral": [(np.eye(3), [x, 0.0, 0.0]) for x in (0.02, 0.05)],
        "dolly": _dolly(3),
        "yaw": [(_roty(a), [0.0, 0.0, 0.0]) for a in (-3.0, 3.0)],
        "yaw_pitch": [(_rotx(3.0) @ _roty(4.0), [0.05, 0.01, 0.0]),
                      (_rotx(-2.0) @ _roty(-3.0), [-0.04, 0.0, 0.01])],
    }[case]
    cams = [lif_tpu_torch.Camera.create(128, 112, focal_px=0.78 * 128,
                                        position=c, rotation=r)
            for r, c in poses]
    plan = trenderer.plan_tiers(tp, cams)
    _, tiers = lif_tpu_torch.render_fast_batch(tp, cams, return_tiers=True)
    assert tuple(p[0] for p in plan.planned) == tiers == (
        {"lateral": "march", "dolly": "scaled", "yaw": "target",
         "yaw_pitch": "rotated"}[case],)
    mode, setup, extra = plan.planned[0]
    f1 = plan.tex_layers[0]["focal_host"]
    if mode == "scaled":
        splan, k, fr, dxu, dyu = setup
        tabs = tss.scaled_table_stack(splan, extra["grids"], torch.as_tensor(
            plan.pos_b, dtype=torch.float32), f1, fr, dxu, dyu)
        assert (splan.out_w, splan.out_h) == (plan.out_w_eff, 112)
    elif mode == "rotated":
        splan, wi, hi, k = setup[:4]
        tabs = tss.scaled_table_stack(splan, extra["grids"], extra["aligned"],
                                      f1, 1.0)
        assert (splan.out_w, splan.out_h) == (wi, hi)
    else:
        return
    assert tabs.shape == (len(poses), 5, k)
    assert bool(torch.isfinite(tabs).all())


_SK0 = (0.01, -0.02)
_INTRINSICS_TEXT = ("render_fast_batch cameras must share intrinsics "
                    "(width/height/focal/skew)")


def _allclose_edge(y, dtype):
    """The largest x of `dtype` above y that np.allclose(x, y) accepts, and
    the next one up, which it rejects (bisection on the bit patterns)."""
    ints = {np.float32: np.int32, np.float64: np.int64}[dtype]
    lo = np.asarray(y, dtype).view(ints)
    hi = np.asarray(float(y) + 1e-6, dtype).view(ints)
    while hi - lo > 1:
        mid = lo + (hi - lo) // 2
        if np.allclose(np.asarray(mid).view(dtype), y):
            lo = mid
        else:
            hi = mid
    return (np.asarray(lo).view(dtype)[()], np.asarray(hi).view(dtype)[()])


def _loop_shares_intrinsics(cameras):
    """lif_tpu's per-camera intrinsics check in render_fast_batch."""
    cam0 = cameras[0]
    return not any(
        cam.width != cam0.width or cam.height != cam0.height
        or abs(float(cam.focal_px) - float(cam0.focal_px)) > 1e-6
        or not np.allclose(np.asarray(cam.skew), np.asarray(cam0.skew))
        for cam in cameras[1:]
    )


@pytest.mark.parametrize("case,shared", [
    ("same", True), ("skew_in", True), ("skew_out", False),
    ("skew_in_f64", True), ("skew_out_f64", False), ("focal", False),
    ("width", False), ("height", False),
])
def test_plan_tiers_checks_a_lateral_batch_as_the_loop(rng, monkeypatch,
                                                       case, shared):
    """plan_tiers on 432 lateral cameras: its batch check of shared
    intrinsics accepts and raises, with the same text and before any
    texture prep, where lif_tpu's per-camera loop does, at skews just
    inside and just outside np.allclose's tolerance (float32, and a
    float64 skew among float32 ones), a focal one float32 ulp off and a
    width or height off. An accepted batch plans 'march', its pos_b and
    rot_b are lif_tpu's relative_view_pose per camera bit for bit, and its
    snap tables are lif_tpu's per-pose ladders at K."""
    import dataclasses

    from lif_tpu.core.pose import relative_view_pose
    from lif_tpu.ops import sweep_march as jsm

    _, tp = _projectors(rng, h=112)
    w, h, f = 128, 112, 0.78 * 128
    cams = [lif_tpu_torch.Camera.create(
        w, h, focal_px=f, position=(0.115 + 0.02 * i / 432, 0.0, 0.0),
        skew=_SK0) for i in range(432)]
    sk0 = np.asarray(cams[0].skew)
    edge32 = _allclose_edge(sk0[0], np.float32)
    edge64 = _allclose_edge(sk0[0], np.float64)
    change = {
        "same": {},
        "skew_in": dict(skew=np.array([edge32[0], sk0[1]], np.float32)),
        "skew_out": dict(skew=np.array([edge32[1], sk0[1]], np.float32)),
        "skew_in_f64": dict(skew=np.array([edge64[0], sk0[1]], np.float64)),
        "skew_out_f64": dict(skew=np.array([edge64[1], sk0[1]], np.float64)),
        "focal": dict(focal_px=np.nextafter(cams[0].focal_px, np.float32(1e9))),
        "width": dict(width=w + 8),
        "height": dict(height=h + 1),
    }[case]
    cams[217] = dataclasses.replace(cams[217], **change)
    assert _loop_shares_intrinsics(cams) is shared
    if not shared:
        def no_prep(_):
            raise AssertionError("textures prepared before the check")

        monkeypatch.setattr(trenderer, "_prepared_textures", no_prep)
        with pytest.raises(ValueError) as err:
            trenderer.plan_tiers(tp, cams)
        assert str(err.value) == _INTRINSICS_TEXT
        return
    plan = trenderer.plan_tiers(tp, cams)
    assert [p[0] for p in plan.planned] == ["march"]
    pos, rot = zip(*(relative_view_pose(tp.position, tp.rotation,
                                        c.position, c.rotation)
                     for c in cams))
    for got, want in ((plan.pos_b, pos), (plan.rot_b, rot)):
        assert got.dtype == np.float64
        assert np.array_equal(got.view(np.uint64),
                              np.stack(want).view(np.uint64))
    lay = plan.tex_layers[0]
    phase = trenderer._march_fold(
        lay, tp.skew, cams[0].skew, float(np.abs(plan.pos_b[:, 0]).max()),
        plan.out_w_eff, h, plan.dx_pad)[2]
    tab, k = trenderer._march_tables(tp, 0, trenderer.DEFAULT_CONFIG, None,
                                     plan.pos_b[:, 0], phase)
    want = np.stack([jsm.snap_plane_table(
        lay["focal_host"], cx, lay["izmin_host"], lay["izmax_host"],
        num_planes=k, phase_px=phase)[0] for cx in plan.pos_b[:, 0]])
    assert np.array_equal(tab.numpy().view(np.uint32), want.view(np.uint32))
