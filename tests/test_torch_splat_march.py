"""Parity of the port's billboard ladder gather (ops/splat_march.py and
render_billboard_fast_batch) with lif_tpu (CPU).

The host tables are numpy on the same inputs and must be EQUAL to
lif_tpu's. The plain twin (the CUDA kernel's plain version) is held to
lif_tpu's TPU kernel in interpret mode (its CPU evaluation) and to the
eager forward_splat (the scatter the dual is exact for; its jitted
evaluation is not an oracle, tests/test_splat_march.py:4-11), with the
repo's bound for the billboard (tests/test_splat_march.py:106-115): hit
disagreement, and colour mismatches > 1e-6 where both hit, each under
1e-3 of the pixels. That bound tolerates ulp-level coverage flips: the
interpret-mode kernel may contract A * t + Bc into an FMA, the twin
rounds every product. The CUDA kernel runs only on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import lif_tpu
import lif_tpu_torch
from lif_tpu.ops import sweep_march as jsm
from lif_tpu.ops.pallas import splat_march as jbb
from lif_tpu_torch.ops import splat_march as tbb
from lif_tpu_torch.ops import sweep_march as tsm

from .test_rotated_march import _roty
from .test_splat_march import IZMAX, IZMIN, _kernel_out, _smooth_scene, _splat_ref

torch.set_num_threads(1)


def _plans(w, h, max_shift):
    return (jsm.translation_plan(w, h, w, h, max_shift, 0.0),
            tsm.translation_plan(w, h, w, h, max_shift, 0.0))


def _twin_batch(rgb, disp, mask, f1, cxs, h, w, point_size=1.0,
                show_depth=False, plain=None):
    """The port's render_billboard_batch on CPU tensors (its CPU branch,
    billboard_scatter_plain), or with `plain` that plain version pose by
    pose and the same epilogue; planned as
    tests/test_splat_march.py::_kernel_out plans lif_tpu's kernel."""
    plan = tsm.translation_plan(
        w, h, w, h, abs(f1) * max(abs(c) for c in cxs) * IZMIN + 4.0, 0.0)
    ixs, mms, k = tbb.billboard_shift_tables(f1, cxs, IZMIN, IZMAX, plan)
    tex = [torch.from_numpy(a) for a in (rgb, disp, mask)]
    if plain is None:
        return tbb.render_billboard_batch(
            *tex, IZMIN, IZMAX, np.asarray(cxs), float(f1), ixs, mms,
            np.zeros(4), plan, k, cx0=w / 2.0, cy0=h / 2.0,
            point_size=point_size, to_srgb=False,
            show_depth=show_depth).numpy()
    args = tbb.billboard_inputs(*tex, IZMIN, IZMAX, cxs, f1, ixs, mms, plan,
                                k, w / 2.0, h / 2.0, point_size)
    outs = [plain(args[0], args[1], args[2][i], args[3][i], args[4][i],
                  *args[5:]) for i in range(len(cxs))]
    found, tex_, rgba = (torch.stack(p) for p in zip(*outs))
    return tbb.finish_billboard(found, tex_, rgba, np.zeros(4), False,
                                show_depth).numpy()


def _disagreement(ref, got, channels=3):
    """(hit disagreement, colour mismatch) shares of the pixels."""
    hit_r, hit_g = ref[..., 3] > 0.5, got[..., 3] > 0.5
    both = hit_r & hit_g
    mism = (np.abs(got[..., :channels] - ref[..., :channels]).max(-1)
            > 1e-6) & both
    return (hit_r != hit_g).mean(), mism.mean()


@pytest.mark.parametrize("cxs", [[0.3, -0.2, 0.0], [0.25], [-0.18, 0.05],
                                 [0.4, 0.001]])
def test_tables_equal(cxs):
    """billboard_shift_tables and the per-pose float32 scalars equal
    lif_tpu's arrays (render_billboard_batch_pallas, :325-341)."""
    w, h, f1 = 96, 64, 74.88
    jplan, tplan = _plans(w, h, 64.0)
    assert tuple(jplan) == tuple(tplan)
    ja, jm, jk = jbb.billboard_shift_tables(f1, cxs, IZMIN, IZMAX, jplan)
    ta, tm, tk = tbb.billboard_shift_tables(f1, cxs, IZMIN, IZMAX, tplan)
    assert jk == tk and np.array_equal(ja, ta) and np.array_equal(jm, tm)
    assert ta.dtype == np.int32 and tm.dtype == np.float32
    abp = tbb.billboard_pose_scalars(f1, cxs, IZMIN, IZMAX, 1.2, w, h)
    c1 = jnp.asarray(np.asarray(cxs, np.float32))
    a_pose = jnp.float32(f1) * c1
    izmin, izmax = jnp.float32(IZMIN), jnp.float32(IZMAX)
    corner = np.sqrt(((w + 1.0) / 2.0 / f1) ** 2
                     + ((h + 1.0) / 2.0 / f1) ** 2 + 1.0)
    want = jnp.stack([a_pose * (izmin - izmax), a_pose * izmax,
                      jnp.full_like(a_pose, 0.5 * 1.2 * corner)], axis=1)
    assert np.array_equal(abp, np.asarray(want))


def test_clipped_real_shift_raises():
    """A plan whose window cannot hold a real shift: lif_tpu clips it
    silently (corrupting that plane's m), the port raises."""
    w, h, f1 = 96, 64, 74.88
    jplan, tplan = _plans(w, h, 8.0)  # pads 64 px; the ladder needs ~150
    _, mms, _ = jbb.billboard_shift_tables(f1, [1.0], IZMIN, IZMAX, jplan)
    assert mms.max() < f1 * 1.0 * IZMIN  # the near shifts were clipped
    with pytest.raises(ValueError, match="window"):
        tbb.billboard_shift_tables(f1, [1.0], IZMIN, IZMAX, tplan)


@pytest.mark.parametrize("cx", [0.25, -0.18, 0.0])
def test_twin_matches_kernel_and_eager_oracle(rng, cx):
    """The plain twin (the dual, billboard_march_plain) against lif_tpu's
    TPU kernel in interpret mode and against the eager scatter, at both
    signs of cx and at cx = 0."""
    h, w = 64, 96
    rgb, disp, mask = _smooth_scene(rng, h, w)
    f1 = 0.78 * w
    got = _twin_batch(rgb, disp, mask, f1, [cx], h, w,
                      plain=tbb.billboard_march_plain)[0]
    for ref in (_kernel_out(rgb, disp, mask, f1, [cx], h, w)[0],
                _splat_ref(rgb, disp, f1, cx, h, w)):
        flips, mism = _disagreement(ref, got)
        assert flips < 1e-3 and mism < 1e-3, (flips, mism)
    assert (got[..., 3] > 0.5).mean() > 0.5


@pytest.mark.parametrize("cx,point_size", [(0.25, 1.0), (-0.18, 1.0),
                                           (0.0, 1.0), (0.2, 1.4)])
def test_scatter_matches_kernel_and_eager_oracle(rng, cx, point_size):
    """The scatter's plain version (the CUDA kernel's, and the CPU branch
    of render_billboard_batch) against lif_tpu's TPU kernel in interpret
    mode and the eager scatter, to test_twin_matches_kernel_and_eager_
    oracle's bounds, and equal to the dual twin."""
    h, w = 64, 96
    rgb, disp, mask = _smooth_scene(rng, h, w)
    f1 = 0.78 * w
    got = _twin_batch(rgb, disp, mask, f1, [cx], h, w, point_size,
                      plain=tbb.billboard_scatter_plain)[0]
    refs = [_kernel_out(rgb, disp, mask, f1, [cx], h, w, point_size)[0],
            _splat_ref(rgb, disp, f1, cx, h, w, point_size)]
    for ref in refs:
        flips, mism = _disagreement(ref, got)
        assert flips < 1e-3 and mism < 1e-3, (flips, mism)
    dual = _twin_batch(rgb, disp, mask, f1, [cx], h, w, point_size,
                       plain=tbb.billboard_march_plain)[0]
    assert np.array_equal(got, dual)
    assert np.array_equal(
        got, _twin_batch(rgb, disp, mask, f1, [cx], h, w, point_size)[0])


def _edge_scene(rng, h, w, lo=0.0, hi=1.0):
    """Random disparity in [lo, hi] (outside [0, 1] where asked) with hard
    near and far boxes, random colour and mask."""
    disp = lo + (hi - lo) * rng.random((h, w))
    disp[h // 4 : h // 2, w // 3 : 2 * w // 3] = 0.95
    disp[h // 2 : 3 * h // 4, w // 5 : w // 3] = 0.05
    rgb = rng.random((h, w, 3), dtype=np.float32)
    mask = (rng.random((h, w)) > 0.3).astype(np.float32)
    return rgb, disp.astype(np.float32), mask


@pytest.mark.parametrize("w,cxs,su,lo,hi", [
    (97, [0.25, -0.18, 0.02], None, 0.0, 1.0),  # odd width, sentinels
    (96, [0.3, -0.3, 0.1], 0.95, 0.0, 1.0),  # su/2 = 0.95
    (64, [0.22, 0.0], 0.8, 0.0, 1.0),  # cx = 0 beside a wide ladder
    (71, [0.2, -0.1], None, -0.3, 1.3),  # disparity outside the ladder
])
def test_scatter_plain_equals_dual(w, cxs, su, lo, hi):
    """billboard_scatter_plain equals billboard_march_plain bit for bit
    (found, tex, rgba) on scenes with hard near-box edges, at both signs of
    cx, su/2 up to 0.95, an odd width, ladders padded with sentinel
    planes, and texels outside [0, 1] (whose parallax the ladder's range
    leaves out: neither version covers anything from them)."""
    h = 40
    rng = np.random.default_rng(w + 13)
    rgb, disp, mask = _edge_scene(rng, h, w, lo, hi)
    f1 = 0.78 * w
    point_size = 1.0 if su is None else su / tbb.su_half_bound(1.0, w, h, f1)
    plan = tsm.translation_plan(
        w, h, w, h, f1 * max(abs(c) for c in cxs) * IZMIN + 4.0, 0.0)
    ixs, mms, k = tbb.billboard_shift_tables(f1, cxs, IZMIN, IZMAX, plan)
    assert (mms[:, -1] == mms[:, -2]).any()  # a sentinel-padded ladder
    args = tbb.billboard_inputs(
        *[torch.from_numpy(a) for a in (rgb, disp, mask)], IZMIN, IZMAX, cxs,
        f1, ixs, mms, plan, k, w / 2.0, h / 2.0, point_size)
    if su is not None:
        assert abs(float(args[4][0, 2]) - su) < 1e-4
    for i in range(len(cxs)):
        one = (args[0], args[1], args[2][i], args[3][i], args[4][i],
               *args[5:])
        dual = tbb.billboard_march_plain(*one)
        scatter = tbb.billboard_scatter_plain(*one)
        for a, b in zip(dual, scatter):
            assert torch.equal(a, b), (i, cxs[i])
        assert 0.3 < float(dual[0].mean()) <= 1.0


def test_su_half_of_one_raises():
    """sweep_billboard (before any device check) and the CPU branch of
    billboard_march_batch raise ValueError where a pose's su/2 reaches 1:
    there neither the scatter nor the dual is the z-buffered splat."""
    from lif_tpu_torch.ops.cuda import splat_march as kbb

    disp = torch.rand(8, 16)
    rgbm = torch.rand(8, 16, 4)
    ix = torch.zeros(2, 8, dtype=torch.int32)
    m = torch.zeros(2, 8)
    geo = (0, 8.0, 4.0, 0.1, 0.5)
    for su in (1.0, 1.5, float("nan")):
        ab = torch.tensor([[0.0, 0.0, 0.5], [0.0, 0.0, su]])
        with pytest.raises(ValueError, match="su/2 < 1"):
            kbb.sweep_billboard(disp, rgbm, ix, m, ab, *geo)
        with pytest.raises(ValueError, match="su/2 < 1"):
            tbb.billboard_march_batch(disp, rgbm, ix, m, ab, *geo)
    ab = torch.tensor([[0.0, 0.0, 0.5], [0.0, 0.0, 0.999]])
    with pytest.raises(ValueError, match="CUDA tensor"):
        kbb.sweep_billboard(disp, rgbm, ix, m, ab, *geo)
    found, _, _ = tbb.billboard_march_batch(disp, rgbm, ix, m, ab, *geo)
    assert found.shape == (2, 8, 16)


def test_batch_equals_per_pose_and_show_depth(rng):
    """A 3-pose batch equals three 1-pose calls (shared K, sentinel
    padding); show_depth shows the winner's disparity texel, as lif_tpu's
    kernel (tests/test_splat_march.py:117-138)."""
    h, w = 64, 96
    rgb, disp, mask = _smooth_scene(rng, h, w)
    f1 = 0.78 * w
    cxs = [0.25, -0.18, 0.05]
    batch = _twin_batch(rgb, disp, mask, f1, cxs, h, w)
    for i, cx in enumerate(cxs):
        assert np.array_equal(batch[i],
                              _twin_batch(rgb, disp, mask, f1, [cx], h, w)[0])
    ref = _kernel_out(rgb, disp, mask, f1, [0.25], h, w, show_depth=True)[0]
    got = _twin_batch(rgb, disp, mask, f1, [0.25], h, w, show_depth=True)[0]
    flips, mism = _disagreement(ref, got, channels=1)
    assert flips < 1e-3 and mism < 1e-3, (flips, mism)
    got_ps = _twin_batch(rgb, disp, mask, f1, [0.2], h, w, point_size=1.4)[0]
    ref_ps = _kernel_out(rgb, disp, mask, f1, [0.2], h, w, point_size=1.4)[0]
    flips, mism = _disagreement(ref_ps, got_ps)
    assert flips < 1e-3 and mism < 1e-3, (flips, mism)


def _projectors(rng, h=64, w=96, skew=(0.0, 0.0), focal=None):
    rgb, disp, mask = _smooth_scene(rng, h, w)
    jp = lif_tpu.projector_from_arrays(
        rgb, disp, mask, focal_px=focal or 0.78 * w, invz_min=IZMIN,
        invz_max=IZMAX, baseline=1.0, skew=skew)
    return jp, lif_tpu_torch.projector_from_reference(jp, device="cpu")


def _cams(w, h, xs, focal=None, rot=None):
    return [lif_tpu_torch.Camera.create(w, h, focal_px=focal or 0.78 * w,
                                        position=[x, 0.0, 0.0], rotation=rot)
            for x in xs]


def test_fast_batch_matches_kernel_and_render(rng):
    """render_billboard_fast_batch through projector_from_reference against
    lif_tpu's TPU kernel (interpret mode) planned as lif_tpu's
    render_billboard_fast_batch plans it, in sRGB over a background; and
    against render(mode='billboard') per frame (the dual's oracle)."""
    h, w = 64, 96
    jp, tp = _projectors(rng, h, w)
    xs = [0.1, 0.22, -0.15]
    bg = np.asarray([0.1, 0.2, 0.3, 0.5], np.float32)
    got = lif_tpu_torch.render_billboard_fast_batch(
        tp, _cams(w, h, xs), background=bg).numpy()
    f1 = float(jp.focal[0])
    c1 = np.asarray([[-x, 0.0, 0.0] for x in xs])
    jplan = jsm.translation_plan(w, h, w, h, f1 * 0.22 * IZMIN + 4.0, 0.0)
    ixs, mms, k = jbb.billboard_shift_tables(f1, c1[:, 0].tolist(), IZMIN,
                                             IZMAX, jplan)
    ref = np.asarray(jbb.render_billboard_batch_pallas(
        jnp.asarray(jp.rgb[0]), jnp.asarray(jp.disp[0]),
        jnp.asarray(jp.mask[0]), IZMIN, IZMAX, jnp.asarray(c1, jnp.float32),
        f1, ixs, mms, jnp.asarray(bg), jplan, k, cx0=w / 2.0, cy0=h / 2.0,
        interpret=True))
    assert got.shape == ref.shape == (3, h, w, 4)
    for i, cam in enumerate(_cams(w, h, xs)):
        flips, mism = _disagreement(ref[i], got[i])
        assert flips < 1e-3 and mism < 1e-3, (i, flips, mism)
        one = lif_tpu_torch.render(tp, cam, mode="billboard",
                                   background=bg).numpy()
        flips, mism = _disagreement(one, got[i])
        assert flips < 1e-3 and mism < 1e-3, (i, flips, mism)


def test_eligibility_raises(rng):
    """Each gate raises ValueError with lif_tpu's message: a rotated pose,
    a mismatched focal, an off-centre principal point, a width that 8
    does not divide; and, beyond lif_tpu, a footprint that reaches
    su >= 2."""
    h, w = 64, 96
    _, tp = _projectors(rng, h, w)
    fast = lif_tpu_torch.render_billboard_fast_batch
    with pytest.raises(ValueError, match="lateral"):
        fast(tp, _cams(w, h, [0.1], rot=_roty(5.0)))
    with pytest.raises(ValueError, match="lateral"):
        fast(tp, [lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                              position=[0.1, 0.05, 0.0])])
    with pytest.raises(ValueError, match="matched focal"):
        fast(tp, _cams(w, h, [0.1], focal=0.8 * w))
    _, skewed = _projectors(rng, h, w, skew=(0.01, 0.0))
    with pytest.raises(ValueError, match="centered principal point"):
        fast(skewed, _cams(w, h, [0.1]))
    _, odd = _projectors(rng, h, 90)
    with pytest.raises(ValueError, match="8-divisible"):
        fast(odd, _cams(90, h, [0.1]))
    with pytest.raises(ValueError, match="su < 2"):
        fast(tp, _cams(w, h, [0.1]), point_size=1.6)
    assert fast(tp, _cams(w, h, [0.1]), point_size=1.5).shape == (1, h, w, 4)


def test_projector_defaults_to_the_card(rng):
    """Without `device`, projector_from_arrays and projector_from_reference
    build their textures on CUDA; where torch sees no card they raise
    (torch's own error: there is no CPU fallback)."""
    rgb, disp, mask = _smooth_scene(rng, 16, 24)
    jp = lif_tpu.projector_from_arrays(rgb, disp, focal_px=18.72,
                                       invz_min=IZMIN, invz_max=IZMAX)
    for build in (
        lambda: lif_tpu_torch.projector_from_arrays(
            rgb, disp, mask, focal_px=18.72, invz_min=IZMIN, invz_max=IZMAX),
        lambda: lif_tpu_torch.projector_from_reference(jp),
    ):
        if torch.cuda.is_available():
            assert build().disp.device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
                build()
    cpu = lif_tpu_torch.projector_from_arrays(
        rgb, disp, mask, focal_px=18.72, invz_min=IZMIN, invz_max=IZMAX,
        device="cpu")
    assert cpu.disp.device.type == "cpu" and cpu.intrinsics == jp.intrinsics
