"""Parity of the port's target-ray march modules with lif_tpu (CPU).

The same numpy inputs go through lif_tpu (JAX on the CPU, its XLA twin
render_target_xla) and through lif_tpu_torch (the plain twin on CPU
tensors). Host planning is float64 numpy and must be EQUAL: it decides
routing. The march must match lif_tpu's twin to the kernel-vs-twin bounds
of tests/test_sweep_target.py (:146-153, :182-186): PSNR >= 60 dB on the
interior, fewer than 0.1% of pixels off by more than 1e-3, median error
below 1e-5. XLA contracts multiply-adds into FMAs on the CPU and the
port does not, so ulp differences can flip grazing crossings at isolated
pixels; the bounds count those, they do not forbid them. The CUDA kernel
runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lif_tpu.ops import composite as jcomp
from lif_tpu.ops import sampling as jsampling
from lif_tpu.ops import sweep_target as jst
from lif_tpu_torch.ops import composite as tcomp
from lif_tpu_torch.ops import sampling as tsampling
from lif_tpu_torch.ops import sweep_target as tst

from .test_rotated_march import _rotx, _roty
from .test_sweep_march import _psnr, _scene

torch.set_num_threads(1)

IZMIN, IZMAX = 2.0, 0.1

# pose batches (rotation, c1) of the tests, all yaw-family
_BATCHES = {
    "yaw2": ([_roty(12.0), _roty(-8.0)],
             [[0.22, 0.0, -0.03], [-0.12, 0.05, 0.02]]),
    "yaw_dolly": ([_roty(10.0)], [[0.18, 0.04, -0.02]]),
    "orbit3": ([_roty(-6.0), _roty(0.5), _roty(4.0)],
               [[-0.1, 0.0, 0.01], [0.0, 0.0, 0.0], [0.05, 0.08, 0.0]]),
}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _setup(rng, batch, h=96, w=128, step_px=1.0, fr=1.0):
    rots, cs = _BATCHES[batch]
    cs = [np.asarray(c, np.float64) for c in cs]
    rgb, disp, mask = _scene(rng, h=h, w=w)
    f1 = 0.78 * w
    f2 = f1 / fr
    plan, _, _ = jst.plan_target(w, h, w, h, f1, f2, rots, cs, IZMIN, IZMAX)
    grids, k = jst.target_plane_grids(rots, cs, f1, f2, w, h, w, h, IZMIN,
                                      IZMAX, step_px=step_px)
    poses = np.stack([jst.target_pose_scalars(r, c, f1, f2, w, h, w, h)
                      for r, c in zip(rots, cs)])
    return rgb, disp, mask, plan, grids, k, poses


@pytest.mark.parametrize("hw", [(96, 128), (112, 128)])
@pytest.mark.parametrize("batch", sorted(_BATCHES))
@pytest.mark.parametrize("fr", [1.0, 1.2])
def test_planning_equal(hw, batch, fr):
    """plan_target, target_extents, bucket_extents, plan_from_extents,
    target_plane_grids and target_pose_scalars: equal outputs."""
    h, w = hw
    rots, cs = _BATCHES[batch]
    f1 = 0.78 * w
    f2 = f1 / fr
    args = (w, h, w, h, f1, f2, rots, cs, IZMIN, IZMAX)
    ea, eb = jst.target_extents(*args), tst.target_extents(*args)
    assert ea.key() == eb.key()
    ba, bb = jst.bucket_extents(ea), tst.bucket_extents(eb)
    assert ba.key() == bb.key()
    for ext_a, ext_b in ((ea, eb), (ba, bb)):
        pa = jst.plan_from_extents(w, h, w, h, ext_a)
        pb = tst.plan_from_extents(w, h, w, h, ext_b)
        assert tuple(pa[0]) == tuple(pb[0])
        assert np.array_equal(pa[1], pb[1]) and np.array_equal(pa[2], pb[2])
    pa, pb = jst.plan_target(*args), tst.plan_target(*args)
    assert tuple(pa[0]) == tuple(pb[0])
    for step_px, num_planes in ((1.0, None), (3.0, None), (1.0, 192)):
        ga, ka = jst.target_plane_grids(
            rots, cs, f1, f2, w, h, w, h, IZMIN, IZMAX, step_px=step_px,
            num_planes=num_planes)
        gb, kb = tst.target_plane_grids(
            rots, cs, f1, f2, w, h, w, h, IZMIN, IZMAX, step_px=step_px,
            num_planes=num_planes)
        assert ka == kb and np.array_equal(ga, gb)
    for r, c in zip(rots, cs):
        assert np.array_equal(
            jst.target_pose_scalars(r, c, f1, f2, w, h, w, h),
            tst.target_pose_scalars(r, c, f1, f2, w, h, w, h),
        )


@pytest.mark.parametrize("case", ["pitch", "odd_width"])
def test_gates_raise_the_same_errors(case):
    """The yaw gate and the width gate (tests/test_sweep_target.py:54-68)
    raise the same ValueError in both packages."""
    if case == "pitch":
        args = (128, 96, 128, 96, 100.0, 100.0, [_rotx(8.0)],
                [np.array([0.1, 0.0, 0.0])], IZMIN, IZMAX)
    else:
        args = (120, 96, 120, 96, 100.0, 100.0, [_roty(5.0)],
                [np.zeros(3)], IZMIN, IZMAX)
    with pytest.raises(ValueError) as ja:
        jst.plan_target(*args)
    with pytest.raises(ValueError) as tb:
        tst.plan_target(*args)
    assert str(ja.value) == str(tb.value)


def _depth_bounds(f_j, v_j, f_t, v_t):
    """tests/test_sweep_target.py:182-186: found flips < 0.1%; on
    agreeing pixels median |dinvz*| < 1e-5 and < 0.1% beyond 1e-3."""
    f_j, f_t = np.asarray(f_j), np.asarray(f_t)
    assert (f_j != f_t).mean() < 1e-3
    err = np.abs(np.asarray(v_j) - np.asarray(v_t)) * (f_j == f_t)
    assert np.median(err) < 1e-5
    assert (err > 1e-3).mean() < 1e-3
    assert f_t.mean() > 0.5


def _image_bounds(ref, got):
    """tests/test_sweep_target.py:146-153: >= 60 dB on the interior,
    median error < 1e-5, < 0.1% of pixels beyond 1e-3."""
    ref, got = np.asarray(ref), np.asarray(got)
    sl = np.s_[..., 4:-4, 4:-4, :]
    assert _psnr(got[sl], ref[sl]) >= 60.0
    err = np.abs(got - ref).max(-1)
    assert (err > 1e-3).mean() < 1e-3
    assert np.median(err) < 1e-5


@pytest.mark.parametrize("hw", [(96, 128), (112, 128)])
@pytest.mark.parametrize("mode,refine,step_px", [
    ("depth", 0, 1.0), ("depth", 2, 3.0), ("color", 0, 1.0),
    ("color", 1, 2.0),
])
def test_plain_twin_matches_xla_twin(rng, hw, mode, refine, step_px):
    """render_target_plain against render_target_xla, pose by pose."""
    h, w = hw
    rgb, disp, mask, plan, grids, k, poses = _setup(
        rng, "yaw2", h=h, w=w, step_px=step_px)
    tex = _t(rgb, disp, mask)
    for bi in range(len(poses)):
        args = (IZMIN, IZMAX, poses[bi], grids[bi], np.zeros(4, np.float32),
                k, w, h)
        kw = dict(mask_mode="none", depth_only=mode == "depth",
                  refine=refine)
        ref = jst.render_target_xla(
            rgb, disp, mask, *[jnp.asarray(a) for a in args[:5]], *args[5:],
            **kw)
        got = tst.render_target_plain(*tex, *args, **kw)
        if mode == "depth":
            _depth_bounds(ref[0], ref[1], got[0].numpy(), got[1].numpy())
        else:
            _image_bounds(ref, got.numpy())


@pytest.mark.parametrize("batch", ["yaw2", "orbit3"])
@pytest.mark.parametrize("mask_mode,to_srgb", [("none", True),
                                               ("multiply", False),
                                               ("hard", False)])
def test_fetch_batch_matches_lif_tpu(rng, batch, mask_mode, to_srgb):
    """The production tier: depth-only march + packed color fetch +
    epilogue, against lif_tpu's render_target_fetch_batch."""
    rgb, disp, mask, plan, grids, k, poses = _setup(rng, batch)
    mask = (rng.random(mask.shape) > 0.15).astype(np.float32)
    bg = np.asarray([0.1, 0.2, 0.3, 1.0], np.float32)
    kw = dict(feathering=0.1, mask_mode=mask_mode, to_srgb=to_srgb)
    ref = jst.render_target_fetch_batch(
        rgb, disp, mask, IZMIN, IZMAX, jnp.asarray(poses),
        jnp.asarray(grids), jnp.asarray(bg), plan, None, None, k, **kw)
    got = tst.render_target_fetch_batch(
        *_t(rgb, disp, mask), IZMIN, IZMAX, torch.from_numpy(poses),
        torch.from_numpy(grids), bg, plan, k, **kw)
    assert got.shape == (len(poses), 96, 128, 4)
    _image_bounds(ref, got.numpy())


def test_full_color_batch_and_raw_match_lif_tpu(rng):
    """render_target_batch (the in-kernel bracket color lerp) and its raw
    tuple against lif_tpu's render_target_batch on the CPU."""
    rgb, disp, mask, plan, grids, k, poses = _setup(rng, "orbit3")
    for raw in (False, True):
        ref = jst.render_target_batch(
            rgb, disp, mask, IZMIN, IZMAX, poses, grids,
            jnp.zeros(4), plan, None, None, k, raw=raw)
        got = tst.render_target_batch(
            *_t(rgb, disp, mask), IZMIN, IZMAX, torch.from_numpy(poses),
            torch.from_numpy(grids), np.zeros(4, np.float32), plan, k,
            raw=raw)
        if not raw:
            _image_bounds(ref, got.numpy())
            continue
        for name, a, b in zip(("rgba", "alpha", "hit", "invz"), ref, got):
            err = np.abs(np.asarray(a) - b.numpy())
            assert (err > 1e-3).mean() < 1e-3, name
            assert np.median(err) < 1e-5, name


def test_batch_equals_per_pose(rng):
    """A pose batch is a batching detail: each pose of the batched fetch
    equals the same pose rendered alone (exactly)."""
    rgb, disp, mask, plan, grids, k, poses = _setup(rng, "orbit3")
    tex = _t(rgb, disp, mask)
    whole = tst.render_target_fetch_batch(
        *tex, IZMIN, IZMAX, torch.from_numpy(poses), torch.from_numpy(grids),
        np.zeros(4, np.float32), plan, k)
    for i in range(len(poses)):
        one = tst.render_target_fetch_batch(
            *tex, IZMIN, IZMAX, torch.from_numpy(poses[i : i + 1]),
            torch.from_numpy(grids[i : i + 1]), np.zeros(4, np.float32),
            plan, k)
        assert torch.equal(one[0], whole[i])


def test_pack_and_packed_fetch_match(rng):
    """pack_rgbm is equal (10-bit rounding half to even, the mask bit),
    bilinear_sample_packed agrees to 1e-6, off the texture's edges too."""
    rgb = rng.random((17, 23, 3), dtype=np.float32)
    rgb[0, :4, 0] = np.array([0.5, 1.5, 2.5, 1022.5], np.float32) / 1023.0
    rgb[1, :2] = [[-0.2, 1.3, 1.0], [0.0, 0.5, 1.0]]
    mask = rng.random((17, 23)).astype(np.float32)
    pa = np.asarray(jsampling.pack_rgbm(jnp.asarray(rgb), jnp.asarray(mask)))
    pb = tsampling.pack_rgbm(*_t(rgb, mask))
    assert pb.dtype == torch.int32 and np.array_equal(pa, pb.numpy())
    u = rng.uniform(-0.1, 1.1, (20, 30)).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, (20, 30)).astype(np.float32)
    a = jsampling.bilinear_sample_packed(jnp.asarray(pa), jnp.asarray(u),
                                         jnp.asarray(v), 23, 17)
    b = tsampling.bilinear_sample_packed(pb, *_t(u, v), 23, 17)
    assert b.shape == (20, 30, 4)
    assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-6


@pytest.mark.parametrize("mask_mode", ["none", "multiply", "hard"])
def test_edge_alpha_on_packed_mask(rng, mask_mode):
    """edge_alpha with the mask channel of a packed fetch (bilinear
    blends of 0/1 bits, so fractional at mask edges)."""
    mask = (rng.random((24, 32)) > 0.4).astype(np.float32)
    packed = tsampling.pack_rgbm(
        torch.from_numpy(rng.random((24, 32, 3), dtype=np.float32)),
        torch.from_numpy(mask))
    u = rng.uniform(-0.05, 1.05, (40, 50)).astype(np.float32)
    v = rng.uniform(-0.05, 1.05, (40, 50)).astype(np.float32)
    m = tsampling.bilinear_sample_packed(packed, *_t(u, v), 32, 24)[..., 3]
    assert 0.0 < float(((m > 0) & (m < 1)).float().mean()) < 1.0
    found = (rng.random((40, 50)) > 0.2).astype(np.float32)
    ja = jcomp.edge_alpha(*map(jnp.asarray, (found, u, v)), 0.1,
                          jnp.asarray(m.numpy()), mask_mode)
    ta = tcomp.edge_alpha(*_t(found, u, v), 0.1, m, mask_mode)
    for p, q in zip(ja, ta):
        assert np.abs(np.asarray(p) - q.numpy()).max() < 1e-6


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), h=st.integers(2, 40),
       w=st.integers(2, 70), scale=st.sampled_from([1.0, 1e-3, 1e4]),
       offset=st.sampled_from([0.0, -0.5, 0.7]))
def test_skip_tables_bound_every_read(seed, h, w, scale, offset):
    """Every bilinear read (_bil, the kernel's) at any position, inside the
    source or clamped at its edges, is at most its b0 entry, and b0 at most
    its b8 and b32 cells; b0 is the four taps' max plus their max|tap|
    times 2^-16 plus 1e-30 (the stated slack, no looser), on scenes of
    either sign and of large and small magnitude; a NaN tap gives +inf."""
    rng = np.random.default_rng(seed)
    disp = ((rng.random((h, w)) + offset) * scale).astype(np.float32)
    b0, b8, b32 = tst.skip_tables(torch.from_numpy(disp))
    taps = np.stack([disp[:-1, :-1], disp[:-1, 1:], disp[1:, :-1],
                     disp[1:, 1:]]).astype(np.float64)
    hi, mag = taps.max(0), np.abs(taps).max(0)
    b0n = b0.numpy().astype(np.float64)
    assert (b0n >= hi).all()
    assert (b0n <= hi + mag * 2.0 ** -16 * (1 + 2.0 ** -6) + 2e-30).all()
    px = torch.from_numpy(rng.uniform(-3.0, w + 2.0, 4000).astype(np.float32))
    py = torch.from_numpy(rng.uniform(-3.0, h + 2.0, 4000).astype(np.float32))
    px[:8] = torch.tensor([0.0, w - 1.0, w - 2.0, -0.0, 1e-7, w - 1.5,
                           -1e30, 1e30])
    reads = tst._bil(torch.from_numpy(disp), px, py)
    ox, oy = tst._origin(px, w), tst._origin(py, h)
    assert (reads <= b0[oy, ox]).all()
    assert (b0[oy, ox] <= b8[oy // 8, ox // 8]).all()
    assert (b8[oy // 8, ox // 8] <= b32[oy // 32, ox // 32]).all()
    disp[h // 2, w // 2] = np.nan
    b0, b8, _ = tst.skip_tables(torch.from_numpy(disp))
    y, x = min(h // 2, h - 2), min(w // 2, w - 2)
    assert b0[y, x] == np.inf and b8[y // 8, x // 8] == np.inf


def _far_scene(h, w):
    """A far background ramp behind a near box (long skipped runs)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = 0.04 + 0.12 * xx / w + 0.01 * np.sin(yy / 7)
    disp[h // 3 : h // 2, w // 4 : w // 2] = 0.95
    rgb = np.random.default_rng(h).random((h, w, 3), dtype=np.float32)
    return rgb, disp.astype(np.float32), np.ones((h, w), np.float32)


@pytest.mark.parametrize("scene", ["noise", "far"])
@pytest.mark.parametrize("mode,refine,step_px,run,out_hw", [
    ("depth", 0, 1.0, tst.SKIP_RUN, None), ("depth", 1, 2.0, 8, None),
    ("color", 0, 1.0, tst.SKIP_RUN, None), ("depth", 2, 1.0, 32, (37, 100)),
])
def test_skip_walk_equals_plain_march(rng, scene, mode, refine, step_px, run,
                                      out_hw):
    """march_target_skip_plain, the CUDA kernel's walk with its exact
    skips, gives march_target_plain's found, invz* (and rgba*) bit for
    bit: depth only at refine 0, 1 and 2, full colour, runs of 8, 16 and
    32 planes, an output whose width is not a whole number of warps; and
    its skips do fire (b0 tests saving tap reads; on the far scene,
    skipped runs)."""
    h, w = 96, 128
    rots, cs = _BATCHES["yaw2"]
    if scene == "noise":
        rgb, disp, mask = _scene(rng, h=h, w=w)
    else:
        rgb, disp, mask = _far_scene(h, w)
    out_h, out_w = out_hw or (h, w)
    f1 = 0.78 * w
    grids, _ = tst.target_plane_grids(rots, cs, f1, f1, out_w, out_h, w, h,
                                      IZMIN, IZMAX, step_px=step_px)
    tex = _t(rgb, disp, mask)
    rgbm = tst._rgbm_stack(tex[0], tex[2]) if mode == "color" else None
    stats = {}
    for r, c, grid in zip(rots, cs, grids):
        pose = tst.target_pose_scalars(r, np.asarray(c), f1, f1, out_w,
                                       out_h, w, h)
        want = tst.march_target_plain(tex[1], IZMIN, IZMAX, pose, grid,
                                      out_w, out_h, refine=refine, rgbm=rgbm)
        got = tst.march_target_skip_plain(tex[1], IZMIN, IZMAX, pose, grid,
                                          out_w, out_h, refine=refine,
                                          rgbm=rgbm, run=run, stats=stats)
        for a, b in zip(want, got):
            assert torch.equal(a, b)
    assert stats["runs_skipped"] > 0 or scene == "noise"
    assert stats["bil_reads"] < stats["lane_tests"] <= stats["old_lane_visits"]


def test_plain_march_rejects_other_devices(rng):
    """The dispatch takes CUDA (the kernel) or CPU (the plain twin)
    tensors; any other device raises."""
    rgb, disp, mask, plan, grids, k, poses = _setup(rng, "yaw_dolly")
    tex = [t.to("meta") for t in _t(rgb, disp, mask)]
    with pytest.raises(NotImplementedError, match="CUDA or CPU"):
        tst.render_target_fetch_batch(
            *tex, IZMIN, IZMAX, torch.from_numpy(poses),
            torch.from_numpy(grids), np.zeros(4, np.float32), plan, k)
