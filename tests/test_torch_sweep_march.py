"""Parity of the port's lateral-march modules with lif_tpu (CPU).

The same numpy inputs go through lif_tpu (JAX on the CPU; its Pallas
kernel through interpret mode where a test needs it) and through
lif_tpu_torch. Planning is host math and must match exactly; the plain
twin must match lif_tpu's XLA oracle to the kernel-vs-twin gate of
tests/test_sweep_march.py (max abs < 3e-5, < 1e-4 with refine). The
plain mirror of the CUDA kernel's skip walk must equal the plain march
bit for bit, and its row tables must bound every read. The CUDA kernel
itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from lif_tpu.ops import sweep_march as jsm
from lif_tpu.ops.pallas import bounds as jbounds
from lif_tpu.ops.pallas import sweep_march as jpallas
from lif_tpu_torch.ops import sweep_march as tsm
from lif_tpu_torch.ops.cuda import sweep_march as tcuda

torch.set_num_threads(1)


def _scene(rng, h=96, w=128):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = 0.5 + 0.3 * np.sin(xx / 17) * np.cos(yy / 13)
    disp[30:60, 40:80] = 0.95  # near box: a hard depth edge
    rgb = rng.random((h, w, 3), dtype=np.float32)
    mask = (rng.random((h, w)) > 0.2).astype(np.float32)
    return rgb, disp.astype(np.float32), mask


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("cx", [0.003, 0.05, -0.137, 0.155])
@pytest.mark.parametrize("stride,phase", [(1, 0.0), (2, 0.0), (1, -0.3)])
def test_snap_plane_tables_equal(cx, stride, phase):
    """Snap grids and their bucketed K: exact equality (host math)."""
    f1, izmin, izmax = 998.4, 0.0001 / 0.045, 0.09 / 0.045
    izmin, izmax = izmax, izmin  # near (large invz) first
    a, ka = jsm.snap_plane_table(f1, cx, izmin, izmax, stride=stride,
                                 phase_px=phase)
    b, kb = tsm.snap_plane_table(f1, cx, izmin, izmax, stride=stride,
                                 phase_px=phase)
    assert ka == kb and np.array_equal(a, b)
    cxs = [cx, cx * 0.5, cx + 0.01]
    ta, ka = jsm.snap_plane_tables_batch(f1, cxs, izmin, izmax, stride=stride)
    tb, kb = tsm.snap_plane_tables_batch(f1, cxs, izmin, izmax, stride=stride)
    assert ka == kb and np.array_equal(ta, tb)


_SFMOMA = (0.78 * 1280, 0.09 / 0.045, 0.0001 / 0.045)  # f1, izmin, izmax
_BATCH_CASES = {
    # flat poses (sub-pixel parallax) among large ones
    "flat_mixed": (_SFMOMA, [1e-7, 0.155, -2e-7, 0.03, 0.0], {}),
    # both signs of cx and cx = 0 in one batch, at a phase
    "signs_phase": (_SFMOMA, [-0.06, -0.01, 0.0, 0.01, 0.06],
                    dict(phase_px=0.37)),
    "stride": (_SFMOMA, [0.115, -0.08, 0.02], dict(stride=3, phase_px=-0.3)),
    # 0.9 and -1.2 pass max_planes: their strides double, 0.02 keeps 1
    "doubling": (_SFMOMA, [0.9, 0.02, -1.2], {}),
    "doubling_small_cap": (_SFMOMA, [0.155, 0.05], dict(max_planes=64)),
    "explicit": (_SFMOMA, [0.115, -0.155, 0.0], dict(num_planes=512)),
    "explicit_cap": (_SFMOMA, [0.155, 0.01], dict(num_planes=128)),
    "single": (_SFMOMA, [0.135], {}),
    # the trajectory cell's batch: 432 poses along x
    "trajectory": (_SFMOMA, [0.115 + 0.02 * i / 432 for i in range(432)],
                   {}),
    # both range endpoints on integer shifts are filtered out, so the
    # 62-plane ladder buckets to K = 64 but caps there at stride 2
    "endpoints_filtered": ((100.0, 2.0, 0.0), [-0.3125, 0.3125, 0.01], {}),
}


@pytest.mark.parametrize("case", sorted(_BATCH_CASES))
def test_snap_plane_tables_batch_bit_equal(case):
    """The one-pass batch builder: every row is lif_tpu's per-pose
    snap_plane_table at the returned K, bit for bit (uint32 views), and K
    is lif_tpu's batch K."""
    (f1, izmin, izmax), cxs, kw = _BATCH_CASES[case]
    tab, k = tsm.snap_plane_tables_batch(f1, cxs, izmin, izmax, **kw)
    _, kj = jsm.snap_plane_tables_batch(f1, cxs, izmin, izmax, **kw)
    assert k == kj and tab.shape == (len(cxs), k) and tab.dtype == np.float32
    for row, cx in zip(tab, cxs):
        want, kw_k = jsm.snap_plane_table(f1, cx, izmin, izmax,
                                          **dict(kw, num_planes=k))
        assert kw_k == k
        assert np.array_equal(row.view(np.uint32), want.view(np.uint32))
    if case.startswith("doubling"):  # more integer shifts than planes
        span = f1 * max(map(abs, cxs)) * (izmin - izmax)
        assert k <= kw.get("max_planes", 1024) < span


@pytest.mark.parametrize("dims", [(128, 96, 128, 96), (160, 112, 128, 96),
                                  (1280, 800, 1280, 800)])
@pytest.mark.parametrize("shift", [(0.0, 0.0), (9.6, 0.0), (310.2, 4.0)])
def test_translation_plan_equal(dims, shift):
    """The pad plan is identical field by field."""
    assert tuple(jsm.translation_plan(*dims, *shift)) == tuple(
        tsm.translation_plan(*dims, *shift)
    )


def test_plane_tables_match():
    """Window starts equal; fractions within 1e-6 (both f32)."""
    f1, izmin, izmax = 997.3, 2.0, 0.1
    plan = jsm.translation_plan(1280, 800, 1280, 800, f1 * 0.16 * izmin, 0.0)
    for cx, dx in ((0.137, 0.0), (-0.06, 0.5), (0.155, 0.0)):
        plane, _ = jsm.snap_plane_table(f1, cx, izmin, izmax)
        c1 = np.array([cx, 0.0, 0.0], np.float32)
        ja = jsm.plane_tables(plan, jnp.asarray(plane), jnp.asarray(c1), f1,
                              dx=dx)
        ta = tsm.plane_tables(tsm.TranslationPlan(*plan),
                              torch.from_numpy(plane), torch.from_numpy(c1),
                              f1, dx=dx)
        for i in (0, 2):  # integer starts
            assert np.array_equal(np.asarray(ja[i]), ta[i].numpy())
        for i in (1, 3):  # fractions
            assert np.abs(np.asarray(ja[i]) - ta[i].numpy()).max() <= 1e-6


def test_pad_and_preshift_match(rng):
    """Edge-replicate padding equal; the skew pre-shift within 1e-6."""
    rgb, disp, mask = _scene(rng)
    plan = jsm.translation_plan(128, 96, 128, 96, 40.0, 3.0)
    jd, jc = jsm.pad_sources(plan, *map(jnp.asarray, (rgb, disp, mask)))
    td, tc = tsm.pad_sources(tsm.TranslationPlan(*plan), *_t(rgb, disp, mask))
    assert np.array_equal(np.asarray(jd), td.numpy())
    assert np.array_equal(np.asarray(jc), tc.numpy())
    for arr in (disp, rgb):
        a = np.asarray(jsm.preshift_source(jnp.asarray(arr), 0.3, -1.7))
        b = tsm.preshift_source(torch.from_numpy(arr), 0.3, -1.7).numpy()
        assert np.abs(a - b).max() <= 1e-6


@pytest.mark.parametrize("w,cxs", [(128, (0.01, 0.035, 0.06)),
                                   (120, (0.05, -0.02)),
                                   (96, (0.155,))])
def test_skip_tables_and_loop_bounds_equal(rng, w, cxs):
    """The plane-range scan: the sliding coarse max/min tables and the
    per-tile (k_lo, k_hi) tables equal lif_tpu's exactly (band widths
    128, 8 and 32; two row chunks at h=160)."""
    h = 160
    disp = np.clip(
        rng.random((h, w), dtype=np.float32) * 0.4 + 0.3, 0.0, 1.0
    ).astype(np.float32)
    disp[40:90, 20:60] = 0.97
    rgb = rng.random((h, w, 3), dtype=np.float32)
    mask = np.ones((h, w), np.float32)
    f1, izmin, izmax = 0.78 * w, 2.0, 0.1
    plan = jsm.translation_plan(w, h, w, h, f1 * max(map(abs, cxs)) * izmin,
                                0.0)
    tplan = tsm.TranslationPlan(*plan)
    src_t, jcm3, jcmin3, _ = jpallas.prepare_translation_src(
        *map(jnp.asarray, (rgb, disp, mask)), plan
    )
    src, cm3, cmin3 = tcuda.prepare_translation_src(
        *_t(rgb, disp, mask), tplan
    )
    assert np.array_equal(src.numpy(),
                          np.concatenate([rgb.transpose(2, 0, 1),
                                          mask[None], disp[None]]))
    assert np.array_equal(np.asarray(jcm3), cm3.numpy())
    assert np.array_equal(np.asarray(jcmin3), cmin3.numpy())
    # the tables straight from the padded disparity as well
    cm3_d, _ = tcuda._skip_tables(
        torch.from_numpy(np.asarray(src_t[4]).T.copy()), tcuda._pick_tw(w)
    )
    assert np.array_equal(np.asarray(jcm3), cm3_d.numpy())

    tabs, k = jsm.snap_plane_tables_batch(f1, list(cxs), izmin, izmax)
    c1 = np.stack([np.asarray(cxs, np.float32),
                   np.zeros(len(cxs), np.float32),
                   np.zeros(len(cxs), np.float32)], -1)
    ix = np.array(jax.vmap(lambda cc, pp: jsm.plane_tables(plan, pp, cc, f1))(
        jnp.asarray(c1), jnp.asarray(tabs))[0])
    tkt = (tabs - np.float32(izmax)) / (np.float32(izmin) - np.float32(izmax))
    tw = jpallas._pick_tw(w)
    band_cell = jnp.arange(w // tw, dtype=jnp.int32) * (tw // 8)
    co_all = band_cell[None, None, :] + (jnp.asarray(ix) // 8)[:, :, None]
    jklo, jkhi = jbounds.plane_loop_bounds(
        co_all, jnp.asarray(tkt)[:, :, None, None], k,
        gather_max=lambda c: jcm3[c], gather_min=lambda c: jcmin3[c],
        ncells=jcm3.shape[0],
    )
    klo, khi = tcuda.lateral_loop_bounds(
        cm3, cmin3, torch.from_numpy(ix), torch.from_numpy(tkt), w, k
    )
    assert np.array_equal(np.asarray(jklo), klo.numpy())
    assert np.array_equal(np.asarray(jkhi), khi.numpy())
    # the bounds do prune: some tile starts late or ends early
    assert (klo.numpy() > 0).any() or (khi.numpy() < k).any()


def _twin_args(rng, cx=0.05, K=64, snap=False):
    h, w = 96, 128
    disp = rng.random((h, w), dtype=np.float32)
    rgb = rng.random((h, w, 3), dtype=np.float32)
    mask = (rng.random((h, w)) > 0.2).astype(np.float32)
    izmin, izmax = 2.0, 0.1
    f1 = 0.78 * w
    c1 = np.array([cx, 0.0, 0.0], np.float32)
    if snap:
        plane, K = jsm.snap_plane_table(f1, cx, izmin, izmax)
    else:
        plane = (izmax + (izmin - izmax) * np.linspace(0.999, 0.001, K)
                 ).astype(np.float32)
    plan = jsm.translation_plan(w, h, w, h, f1 * abs(cx) * izmin, 0.0)
    return dict(rgb=rgb, disp=disp, mask=mask, izmin=izmin, izmax=izmax,
                c1=c1, f1=f1, plane=plane, K=K, plan=plan,
                bg=np.asarray([0.1, 0.2, 0.3, 1.0], np.float32))


def _both(a, **kw):
    j = jsm.render_translation_xla(
        *map(jnp.asarray, (a["rgb"], a["disp"], a["mask"])),
        a["izmin"], a["izmax"], jnp.asarray(a["c1"]), a["f1"],
        jnp.asarray(a["plane"]), jnp.asarray(a["bg"]), plan=a["plan"],
        num_planes=a["K"], **kw,
    )
    j = tuple(map(np.asarray, j)) if kw.get("raw") else np.asarray(j)
    t = tsm.render_translation_plain(
        *_t(a["rgb"], a["disp"], a["mask"]), a["izmin"], a["izmax"], a["c1"],
        a["f1"], a["plane"], a["bg"], tsm.TranslationPlan(*a["plan"]), a["K"],
        **kw,
    )
    return j, t


@pytest.mark.parametrize("refine,tol", [(0, 3e-5), (3, 1e-4)])
@pytest.mark.parametrize("mask_mode", ["none", "multiply"])
def test_plain_twin_matches_xla_oracle(rng, refine, tol, mask_mode):
    """render_translation_plain == lif_tpu's render_translation_xla: max
    abs < 3e-5 (the kernel-vs-twin gate of tests/test_sweep_march.py),
    < 1e-4 with refine."""
    a = _twin_args(rng)
    j, t = _both(a, mask_mode=mask_mode, refine=refine)
    assert t.shape == j.shape == (96, 128, 4)
    assert np.abs(j - t.numpy()).max() < tol


@pytest.mark.parametrize("snap", [False, True])
def test_plain_twin_raw_outputs_match(rng, snap):
    """raw=True: hit equal, alpha/invz*/rgba* within 3e-5, on a dense
    uniform grid and on a snap grid (linear, no gamma)."""
    a = _twin_args(rng, cx=-0.06, snap=snap)
    j, t = _both(a, mask_mode="multiply", raw=True, to_srgb=False)
    rgba_j, alpha_j, hit_j, iz_j = j
    rgba_t, alpha_t, hit_t, iz_t = (x.numpy() for x in t)
    assert np.array_equal(hit_j, hit_t)
    assert hit_t.mean() > 0.5
    for x, y in ((rgba_j, rgba_t), (alpha_j, alpha_t), (iz_j, iz_t)):
        assert np.abs(x - y).max() < 3e-5


def test_first_plane_crossing_snaps_to_nearest_plane(rng):
    """disp == 1 everywhere: every ray crosses at plane 0 and the solved
    surface sits at the first plane (the k == 0 snap), as in lif_tpu."""
    a = _twin_args(rng, K=16)
    a["disp"] = np.ones_like(a["disp"])
    j, t = _both(a, raw=True)
    assert np.array_equal(np.asarray(j[2]), t[2].numpy())
    assert np.allclose(t[3].numpy()[t[2].numpy() > 0], a["plane"][0])
    assert np.abs(np.asarray(j[0]) - t[0].numpy()).max() < 3e-5


def test_batch_dispatch_on_cpu_equals_per_pose(rng):
    """render_translation_batch on CPU tensors takes the plain twin pose
    by pose: batch == per-pose, with (K,) shared and (B, K) planes."""
    a = _twin_args(rng)
    cxs = np.asarray([0.01, 0.035, 0.06], np.float32)
    c1_b = np.stack([cxs, np.zeros(3, np.float32), np.zeros(3, np.float32)], -1)
    plan = tsm.translation_plan(128, 96, 128, 96, a["f1"] * 0.06 * 2.0, 0.0)
    args = (*_t(a["rgb"], a["disp"], a["mask"]), a["izmin"], a["izmax"])
    batched = tsm.render_translation_batch(
        *args, c1_b, a["f1"], a["plane"], a["bg"], plan, a["K"],
        mask_mode="multiply",
    )
    per_pose = np.broadcast_to(a["plane"], (3, a["K"])).copy()
    batched_b = tsm.render_translation_batch(
        *args, c1_b, a["f1"], per_pose, a["bg"], plan, a["K"],
        mask_mode="multiply",
    )
    assert torch.equal(batched, batched_b)
    for i in range(3):
        single = tsm.render_translation(
            *args, c1_b[i], a["f1"], a["plane"], a["bg"], plan, a["K"],
            mask_mode="multiply",
        )
        assert torch.equal(batched[i], single)


def test_kernel_wrapper_rejects_cpu_tensors(rng):
    """The kernel wrapper launches on CUDA tensors only: a CPU tensor is
    refused before anything is built (the plain twin is reached only
    through render_translation_batch's CPU dispatch)."""
    a = _twin_args(rng)
    plan = tsm.TranslationPlan(*a["plan"])
    src, cm3, cmin3 = tcuda.prepare_translation_src(
        *_t(a["rgb"], a["disp"], a["mask"]), plan
    )
    b, k = 1, a["K"]
    ix = torch.zeros((b, k), dtype=torch.int32)
    fx = torch.zeros((b, k))
    klo = torch.zeros((b, 1, 1), dtype=torch.int32)
    rows = tsm.row_skip_tables(src[4], 2.0, 0.1)[1:]
    before = tcuda.sweep_lateral.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        tcuda.sweep_lateral(src, ix, fx, fx, klo, klo, 2.0, 0.1, plan,
                            rows=rows)
    assert tcuda.sweep_lateral.launches == before


def test_batch_matches_pallas_kernel_in_interpret_mode(rng):
    """The port's batch on snap grids against lif_tpu's Pallas kernel run
    in interpret mode (the kernel this port's CUDA kernel replaces): max
    abs < 3e-5, the kernel-vs-twin gate."""
    a = _twin_args(rng)
    cxs = [0.02, -0.045]
    tabs, k = jsm.snap_plane_tables_batch(a["f1"], cxs, a["izmin"], a["izmax"])
    c1_b = np.stack([np.asarray(cxs, np.float32), np.zeros(2, np.float32),
                     np.zeros(2, np.float32)], -1)
    plan = jsm.translation_plan(128, 96, 128, 96, a["f1"] * 0.045 * 2.0, 0.0)
    j = np.asarray(jpallas.render_translation_batch_pallas(
        *map(jnp.asarray, (a["rgb"], a["disp"], a["mask"])), a["izmin"],
        a["izmax"], jnp.asarray(c1_b), a["f1"], jnp.asarray(tabs),
        jnp.asarray(a["bg"]), plan=plan, num_planes=k, mask_mode="multiply",
        interpret=True,
    ))
    t = tsm.render_translation_batch(
        *_t(a["rgb"], a["disp"], a["mask"]), a["izmin"], a["izmax"], c1_b,
        a["f1"], tabs, a["bg"], tsm.TranslationPlan(*plan), k,
        mask_mode="multiply",
    )
    assert np.abs(j - t.numpy()).max() < 3e-5


# ---------------------------------------------------------------------------
# The CUDA kernel's skip walk, mirrored in plain torch
# ---------------------------------------------------------------------------


def _skip_case(rng, h, w, out_w, cx, snap, scene="noise"):
    """A scene, its pose and ladder and the plan: 'noise' the twin's
    random disparity, 'far' a far background ramp behind a near box (long
    skipped runs)."""
    if scene == "far":
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        disp = 0.04 + 0.12 * xx / w + 0.01 * np.sin(yy / 7)
        disp[h // 3 : h // 2, w // 4 : w // 2] = 0.95
    else:
        disp = rng.random((h, w), dtype=np.float32)
    rgb = rng.random((h, w, 3), dtype=np.float32)
    mask = (rng.random((h, w)) > 0.2).astype(np.float32)
    izmin, izmax = 2.0, 0.1
    f1 = 0.78 * w
    if snap:
        plane, k = jsm.snap_plane_table(f1, cx, izmin, izmax)
    else:
        k = 64
        plane = (izmax + (izmin - izmax) * np.linspace(0.999, 0.001, k)
                 ).astype(np.float32)
    plan = tsm.translation_plan(w, h, out_w, h, f1 * abs(cx) * izmin + 1.0,
                                0.0)
    return (_t(rgb, disp.astype(np.float32), mask), izmin, izmax,
            np.array([cx, 0.0, 0.0], np.float32), f1, plane, plan, k)


@pytest.mark.parametrize("refine", [0, 1, 2])
@pytest.mark.parametrize("snap,scene,w,run", [
    (True, "noise", 128, tsm.LATERAL_RUN), (False, "noise", 128, 8),
    (False, "far", 128, 16), (True, "far", 127, 32),
])
def test_skip_walk_equals_plain_march(rng, refine, snap, scene, w, run):
    """march_translation_skip_plain, the lateral CUDA kernel's walk with
    its exact skips, gives march_translation_plain's found, invz* and
    rgba* bit for bit: at refine 0, 1 and 2, on snap and non-snap ladders,
    at an odd source width (127, rendered into a 128-column band with the
    width pad's half-pixel offset), runs of 8, 16 and 32 planes; its skips
    fire on the far scene's dense ladder and never read more planes than
    the one-thread walk."""
    out_w = -(-w // 8) * 8
    offset = ((out_w - w) / 2.0, 0.0)
    tex, izmin, izmax, c1, f1, plane, plan, k = _skip_case(
        rng, 96, w, out_w, 0.05, snap, scene)
    stats = {}
    want = tsm.march_translation_plain(*tex, izmin, izmax, c1, f1, plane,
                                       plan, k, refine=refine, offset=offset)
    got = tsm.march_translation_skip_plain(
        *tex, izmin, izmax, c1, f1, plane, plan, k, refine=refine,
        offset=offset, run=run, stats=stats)
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    assert stats["lane_reads"] <= stats["old_lane_visits"]
    if scene == "far" and not snap:
        assert stats["runs_skipped"] > stats["runs"] // 4
    assert want[0].mean().item() > 0.5


def test_skip_walk_crossing_right_after_a_skipped_run(rng):
    """A flat background whose disparity lies halfway between the texel
    thresholds of a run's first plane and the plane before: its pixels
    cross at the first plane of a run after their warps skipped the run
    before whole, so the bracket is read afresh there; still bit for bit
    march_translation_plain's."""
    tex, izmin, izmax, c1, f1, plane, plan, k = _skip_case(
        rng, 96, 128, 128, 0.05, False, "far")
    run = 8
    tkt = (plane - np.float32(izmax)) / (np.float32(izmin) - np.float32(
        izmax))
    c = run * int(np.argmin(np.abs(tkt[run::run] - 0.3)) + 1)
    disp = tex[1].clone()
    disp[disp != np.float32(0.95)] = float((tkt[c - 1] + tkt[c]) / 2)
    tex = [tex[0], disp, tex[2]]
    stats = {}
    for refine in (0, 2):
        want = tsm.march_translation_plain(*tex, izmin, izmax, c1, f1, plane,
                                           plan, k, refine=refine)
        got = tsm.march_translation_skip_plain(
            *tex, izmin, izmax, c1, f1, plane, plan, k, refine=refine,
            run=run, stats=stats)
        for a, b in zip(want, got):
            assert torch.equal(a, b)
    assert stats["after_skip"] > 96 * 128 // 4
    assert stats["refreshes"] >= stats["after_skip"]


def test_skip_walk_through_a_falling_decode(rng):
    """izmin < izmax: the decode falls as the texel rises, so the row
    tables are those of -disp and the plane-range scan runs on the
    negated tables; the walk still equals the dense march."""
    tex, _, _, c1, f1, plane, plan, k = _skip_case(
        rng, 96, 128, 128, 0.05, False, "far")
    for refine in (0, 1):
        want = tsm.march_translation_plain(*tex, 0.1, 2.0, c1, f1, plane,
                                           plan, k, refine=refine)
        got = tsm.march_translation_skip_plain(*tex, 0.1, 2.0, c1, f1, plane,
                                               plan, k, refine=refine)
        for a, b in zip(want, got):
            assert torch.equal(a, b)
        assert 0.1 < want[0].mean().item()


@settings(max_examples=60, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), h=st.integers(1, 12),
       w=st.integers(1, 90), scale=st.sampled_from([1.0, 1e-3, 1e4]),
       offset=st.sampled_from([0.0, -0.5, 0.7]), down=st.booleans())
def test_row_tables_bound_every_lateral_read(seed, h, w, scale, offset, down):
    """Every lateral lerp (the kernel's: taps x0 + ix and x0 + ix + 1
    clamped to the row, weights 1 - f and f) is at most r0 at its origin
    (the first tap clamped to [0, W - 1]), and r0 at most its r8 and r32
    cells; r0 is the pair's max plus its max|tap| times 2^-16 plus 1e-30
    (the stated slack, no looser). Through a falling decode the tables
    bound -disp, i.e. disp from below. A NaN tap gives +inf."""
    rng = np.random.default_rng(seed)
    disp = ((rng.random((h, w)) + offset) * scale).astype(np.float32)
    izmin, izmax = (0.1, 2.0) if down else (2.0, 0.1)
    r0, r8, r32 = tsm.row_skip_tables(torch.from_numpy(disp), izmin, izmax)
    d = -disp if down else disp
    nxt = np.concatenate([d[:, 1:], d[:, -1:]], 1).astype(np.float64)
    pair = np.stack([d.astype(np.float64), nxt])
    hi, mag = pair.max(0), np.abs(pair).max(0)
    r0n = r0.numpy().astype(np.float64)
    assert (r0n >= hi).all()
    assert (r0n <= hi + mag * 2.0 ** -16 * (1 + 2.0 ** -6) + 2e-30).all()
    n = 3000
    row = torch.from_numpy(rng.integers(0, h, n))
    x = torch.from_numpy(rng.integers(-5, w + 5, n))
    f = torch.from_numpy(rng.random(n).astype(np.float32))
    f[:4] = torch.tensor([0.0, 0.5, 1e-7, 0.99999994])
    dt = torch.from_numpy(d)
    a, b = x.clamp(0, w - 1), (x + 1).clamp(0, w - 1)
    reads = dt[row, a] * (1.0 - f) + dt[row, b] * f
    assert (reads <= r0[row, a]).all()
    assert (r0[row, a] <= r8[row, a // 8]).all()
    assert (r8[row, a // 8] <= r32[row, a // 32]).all()
    disp[h // 2, w // 2] = np.nan
    r0, r8, _ = tsm.row_skip_tables(torch.from_numpy(disp), izmin, izmax)
    assert r0[h // 2, w // 2] == np.inf and r8[h // 2, w // 2 // 8] == np.inf
