"""render_fast_view, render(mode='fast'), render_depth_fast and the skewed
lateral fold against lif_tpu (CPU).

The same seeded scene goes through lif_tpu (JAX on the CPU: its XLA twins
of the march tiers) and, carried across with projector_from_reference,
through lif_tpu_torch (the plain twins on CPU tensors). Gates: on the
lateral march (lateral, odd width, y-only through the transpose, every
skew case), lif_tpu's kernel-vs-twin gate, max abs < 3e-5 in linear
light and < 1e-4 in sRGB (tests/test_torch_render.py); on the other
tiers the gates their tier tests use (tests/test_torch_orbit.py: PSNR >=
60 dB against lif_tpu and under 0.1% of the pixels off by more than
1e-3). The lateral kernel's skip mirror on a y-preshifted source, with
row tables built from that source, equals the dense plain march bit for
bit.
"""

import warnings

import numpy as np
import pytest
import torch

import lif_tpu
import lif_tpu_torch
from lif_tpu.models.renderer import render_fast_view as jfast_view
from lif_tpu_torch.models import renderer as trenderer
from lif_tpu_torch.ops import sweep_march as tsm

from .scenes import make_layer, smooth_noise

torch.set_num_threads(1)


def _scene(rng, h, w):
    """Smooth noise plus a hard near box (tests/test_sweep_march.py)."""
    disp = smooth_noise(rng, h, w, octaves=3, lo=0.3, hi=0.8).astype(
        np.float32)
    disp[h // 3 : h // 2, w // 3 : w // 2] = 0.95
    rgb = np.stack([smooth_noise(rng, h, w, octaves=4) for _ in range(3)],
                   -1).astype(np.float32)
    return rgb, disp


def _projectors(rng, h=64, w=128, **kw):
    rgb, disp = _scene(rng, h, w)
    jp = lif_tpu.projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
        baseline=1.0, **kw,
    )
    return jp, lif_tpu_torch.projector_from_reference(jp, device="cpu")


def _psnr(a, b):
    mse = np.mean((a[..., :3] - b[..., :3]) ** 2)
    return 10 * np.log10(1.0 / max(float(mse), 1e-12))


def _assert_tier_gate(got, ref):
    """The non-lateral tiers' gate (tests/test_torch_orbit.py)."""
    assert got.shape == ref.shape
    assert _psnr(got, ref) >= 60.0
    assert (np.abs(got - ref).max(-1) > 1e-3).mean() < 1e-3


# case: (h, w, projector kwargs, camera kwargs, on the lateral march)
_CASES = {
    "lateral": (64, 128, {}, dict(position=[0.04, 0.0, 0.0]), True),
    "odd_width": (64, 127, {}, dict(position=[0.05, 0.0, 0.0]), True),
    "y_only": (64, 128, {}, dict(position=[0.0, 0.03, 0.0]), True),
    "y_only_both_skew": (64, 128, dict(skew=(0.03, -0.0213)),
                         dict(position=[0.0, -0.03, 0.0], skew=(0.01, 0.005)),
                         True),
    "dolly": (64, 128, {}, dict(position=[0.02, 0.01, 0.05]), False),
    "yaw": (96, 128, {}, dict(position=[0.01, 0.0, 0.0],
                              rotation=lif_tpu.orbit_pose(
                                  [0, 0, -1], 1.0, 0.05)[1]), False),
    "projector_skew": (64, 128, dict(skew=(0.03, -0.02)),
                       dict(position=[0.05, 0.0, 0.0]), True),
    "camera_skew": (64, 128, {}, dict(position=[-0.04, 0.0, 0.0],
                                      skew=(0.025, 0.0)), True),
    "both_skew": (64, 128, dict(skew=(0.03, -0.0213)),
                  dict(position=[0.05, 0.0, 0.0], skew=(0.01, 0.005)), True),
    "both_skew_odd_width": (64, 127, dict(skew=(0.03, -0.0213)),
                            dict(position=[0.05, 0.0, 0.0],
                                 skew=(0.01, 0.005)), True),
}


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("to_srgb,tol", [(False, 3e-5), (True, 1e-4)])
def test_fast_view_matches_lif_tpu(rng, case, to_srgb, tol):
    """render_fast_view on every route of lif_tpu's: the lateral march
    (an odd width's pad, every skew: projector, camera only, both-sided
    with a fractional y shift), the y-only transpose (also under both
    skews, which the transpose swaps), a dolly (scaled tier, batch of
    one) and a yaw (target tier)."""
    h, w, pkw, ckw, lateral = _CASES[case]
    jp, tp = _projectors(rng, h, w, **pkw)
    ref = np.asarray(jfast_view(
        jp, lif_tpu.Camera.create(w, h, focal_px=0.78 * w, **ckw),
        to_srgb=to_srgb))
    got = lif_tpu_torch.render_fast_view(
        tp, lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w, **ckw),
        to_srgb=to_srgb)
    assert got.shape == (h, w, 4)
    got = got.numpy()
    if lateral:
        assert np.abs(got - ref).max() < tol
    else:
        _assert_tier_gate(got, ref)


def test_fast_mode_and_routes(rng, monkeypatch):
    """render(mode='fast') is render_fast_view; the y-only pose takes the
    transposed projector and the lateral march (one march per layer), a
    dolly the batch path; the stereo modes need two projectors."""
    _, tp = _projectors(rng)
    cam = lif_tpu_torch.Camera.create(128, 64, focal_px=0.78 * 128,
                                      position=[0.0, 0.02, 0.0])
    calls = []
    real = trenderer._transposed_projector
    monkeypatch.setattr(trenderer, "_transposed_projector",
                        lambda p: calls.append(1) or real(p))
    via_render = lif_tpu_torch.render(tp, cam, mode="fast")
    assert calls == [1]
    assert torch.equal(via_render, lif_tpu_torch.render_fast_view(tp, cam))
    dolly = lif_tpu_torch.Camera.create(128, 64, focal_px=0.78 * 128,
                                        position=[0.01, 0.01, 0.04])
    assert torch.equal(lif_tpu_torch.render_fast_view(tp, dolly),
                       lif_tpu_torch.render_fast_batch(tp, [dolly])[0])
    for mode in ("stereo", "stereo_fast"):
        with pytest.raises(ValueError, match=f"{mode} mode needs two"):
            lif_tpu_torch.render([tp], cam, mode=mode)


def test_fast_view_unported_options_raise(rng):
    """What the single view refuses or ignores, as lif_tpu: method='march'
    on a layer that is not march-eligible (a mismatched focal) raises
    lif_tpu's ValueError; an unknown method raises ValueError; `chunk`,
    the sweep's knob, is not read by a view that marches every layer."""
    _, tp = _projectors(rng, h=32, w=64)
    cam = lif_tpu_torch.Camera.create(64, 32, focal_px=0.78 * 64,
                                      position=[0.03, 0.0, 0.0])
    zoom = lif_tpu_torch.Camera.create(64, 32, focal_px=0.9 * 64,
                                       position=[0.03, 0.0, 0.0])
    with pytest.raises(ValueError, match="method='march'"):
        lif_tpu_torch.render_fast_view(tp, zoom, method="march")
    with pytest.raises(ValueError, match="unknown method"):
        lif_tpu_torch.render_fast_view(tp, cam, method="splat")
    assert torch.equal(lif_tpu_torch.render_fast_view(tp, cam, chunk=7),
                       lif_tpu_torch.render_fast_view(tp, cam))


def _view_case(pkg, case):
    """(projector kwargs, camera, render_fast_view kwargs) of a sweep case
    on the 64x32 scene."""
    f, pos, rot, kw, proj = 0.78 * 64, [0.03, 0.0, 0.0], None, {}, {}
    if case == "method_sweep":
        kw = dict(method="sweep")
    elif case == "exact_color":
        kw = dict(method="sweep", exact_color=True, num_planes=24, chunk=5)
    elif case == "zoom":
        f = 0.9 * 64  # the single view's per-layer fallback
    elif case == "rotated_sweep":
        c, s_ = np.cos(0.1), np.sin(0.1)
        rot = np.array([[c, 0.0, s_], [0.0, 1.0, 0.0], [-s_, 0.0, c]])
        pos, kw = [0.02, 0.01, 0.0], dict(method="sweep")
    elif case == "mixed_ldi":
        proj = "mixed"
    cam = pkg.Camera.create(64, 32, focal_px=f, position=pos, rotation=rot)
    return proj, cam, kw


@pytest.mark.parametrize("case", ["method_sweep", "exact_color", "zoom",
                                  "rotated_sweep", "mixed_ldi"])
def test_fast_view_sweep_routes_match_lif_tpu(rng, case):
    """render_fast_view on the sweep, against lif_tpu on the same inputs:
    method='sweep' on a lateral pose (render_sweep_aligned) and on a
    rotated one (render_rotated), exact_color's first-crossing colour
    fetch, a zoomed lateral view (the per-layer fallback: the layer sweeps
    with TierFallbackWarning) and an LDI whose front layer marches while
    its back layer (another focal) sweeps. The warnings equal lif_tpu's.
    Gate: max abs < 2e-3 in sRGB (the bf16 colour product can round one
    bf16 step apart; tests/test_torch_render.py)."""
    proj, cam_j, kw = _view_case(lif_tpu, case)
    _, cam_t, _ = _view_case(lif_tpu_torch, case)
    if proj == "mixed":
        rgb, disp = _scene(rng, 32, 64)
        back = make_layer(rng, 32, 64, invz_min=0.5, invz_max=0.1)
        mask = (smooth_noise(rng, 32, 64, octaves=2) > 0.35).astype(
            np.float32)
        jp = lif_tpu.projector_from_arrays(
            rgb, disp, mask, focal_px=0.78 * 64, invz_min=2.0, invz_max=0.6,
            baseline=1.0, extra_layers=[dict(
                rgb=back["rgb"], disp=back["disp"], focal_px=0.7 * 64,
                invz_min=0.5, invz_max=0.1)],
        )
        tp = lif_tpu_torch.projector_from_reference(jp, device="cpu")
    else:
        jp, tp = _projectors(rng, h=32, w=64)
    with warnings.catch_warnings(record=True) as jrec:
        warnings.simplefilter("always")
        ref = np.asarray(jfast_view(jp, cam_j, **kw))
    with warnings.catch_warnings(record=True) as trec:
        warnings.simplefilter("always")
        got = lif_tpu_torch.render_fast_view(tp, cam_t, **kw).numpy()
    jw, tw = ([str(r.message) for r in rec
               if r.category.__name__ == "TierFallbackWarning"]
              for rec in (jrec, trec))
    assert tw == jw
    assert len(tw) == (case in ("zoom", "mixed_ldi"))
    assert got.shape == ref.shape == (32, 64, 4)
    assert np.abs(got - ref).max() < 2e-3
    assert ref[..., 3].mean() > 0.5


def _skewed_ldi(rng, h=64, w=128):
    """Two LDI layers, the back one outpainted (taller and wider by even
    margins), with masks and a fractional frustum skew on both axes."""
    rgb0, disp0 = _scene(rng, h, w)
    back = make_layer(rng, h + 16, w + 32, invz_min=0.5, invz_max=0.1)
    mask0 = (smooth_noise(rng, h, w, octaves=2) > 0.35).astype(np.float32)
    jp = lif_tpu.projector_from_arrays(
        rgb0, disp0, mask0, focal_px=0.78 * w, invz_min=2.0, invz_max=0.6,
        baseline=1.0, skew=(0.021, -0.0137),
        extra_layers=[dict(rgb=back["rgb"], disp=back["disp"],
                           focal_px=0.78 * w, invz_min=0.5, invz_max=0.1)],
    )
    return jp, lif_tpu_torch.projector_from_reference(jp, device="cpu")


def test_skewed_outpainted_ldi_layer(rng):
    """A skewed, outpainted LDI layer: the y pre-shift reads the real
    outpaint rows before the center crop. render_fast_view and
    render_fast_batch equal lif_tpu's; tiers ('march', 'march')."""
    jp, tp = _skewed_ldi(rng)
    xs = [0.03, -0.05]
    ckw = dict(focal_px=0.78 * 128, skew=(0.004, 0.0061))
    jcams = [lif_tpu.Camera.create(128, 64, position=[x, 0, 0], **ckw)
             for x in xs]
    tcams = [lif_tpu_torch.Camera.create(128, 64, position=[x, 0, 0], **ckw)
             for x in xs]
    for jc, tc in zip(jcams, tcams):
        ref = np.asarray(jfast_view(jp, jc, to_srgb=False))
        got = lif_tpu_torch.render_fast_view(tp, tc, to_srgb=False).numpy()
        assert np.abs(got - ref).max() < 3e-5
    ref, jt = lif_tpu.render_fast_batch(jp, jcams, to_srgb=False,
                                        return_tiers=True)
    got, tt = lif_tpu_torch.render_fast_batch(tp, tcams, to_srgb=False,
                                              return_tiers=True)
    assert tuple(jt) == tt == ("march", "march")
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 3e-5


@pytest.mark.parametrize("to_srgb,tol", [(False, 3e-5), (True, 1e-4)])
def test_skewed_lateral_batch(rng, to_srgb, tol):
    """A skewed lateral pose batch through render_fast_batch, tiers
    ('march',) (tests/test_skew_fast.py:99-124): equal to lif_tpu's, and
    each pose > 45 dB against the skew-aware exact march."""
    h, w = 96, 128
    jp, tp = _projectors(rng, h, w, skew=(0.03, -0.02))
    xs = [0.02 * i - 0.03 for i in range(4)]
    ckw = dict(focal_px=0.78 * w, skew=(0.01, 0.005))
    ref, jt = lif_tpu.render_fast_batch(
        jp, [lif_tpu.Camera.create(w, h, position=[x, 0, 0], **ckw)
             for x in xs], to_srgb=to_srgb, return_tiers=True)
    cams = [lif_tpu_torch.Camera.create(w, h, position=[x, 0, 0], **ckw)
            for x in xs]
    got, tt = lif_tpu_torch.render_fast_batch(tp, cams, to_srgb=to_srgb,
                                              return_tiers=True)
    assert tuple(jt) == tt == ("march",)
    assert np.abs(got.numpy() - np.asarray(ref)).max() < tol
    if not to_srgb:
        sl = np.s_[8:-8, 12:-12]
        for i, cam in enumerate(cams):
            exact = lif_tpu_torch.render_mono_view(
                tp, cam, mask_mode="none", num_steps=320, to_srgb=False)
            assert _psnr(got[i].numpy()[sl], exact.numpy()[sl]) > 45.0


def test_render_depth_fast_matches_lif_tpu(rng):
    """render_depth_fast: the raw lateral march's invz* times the baseline,
    equal to lif_tpu's to the kernel-vs-twin gate (scaled by the range)
    with the same hit pixels; at identity it reproduces the decoded
    disparity (tests/test_sweep_march.py:460-486); a non-lateral pose or
    a mismatched focal raises."""
    from lif_tpu import render_depth_fast as jdepth

    h, w = 64, 96
    rgb, disp = _scene(rng, h, w)
    izmin, izmax, baseline = 1.8, 0.09, 0.5
    kw = dict(focal_px=0.78 * w, invz_min=izmin, invz_max=izmax,
              baseline=baseline)
    jp = lif_tpu.projector_from_arrays(rgb, disp, **kw)
    tp = lif_tpu_torch.projector_from_reference(jp, device="cpu")
    for x in (0.0, 0.03, -0.02):
        ref = np.asarray(jdepth(jp, lif_tpu.Camera.create(
            w, h, focal_px=0.78 * w, position=[x, 0, 0])))
        got = lif_tpu_torch.render_depth_fast(tp, lif_tpu_torch.Camera.create(
            w, h, focal_px=0.78 * w, position=[x, 0, 0]))
        assert got.dtype == torch.float32 and got.shape == (h, w)
        got = got.numpy()
        assert np.array_equal(got > 0, ref > 0)
        assert np.abs(got - ref).max() < 3e-5 * izmin
        if x == 0.0:
            expect = izmax + (izmin - izmax) * disp
            sl = np.s_[4:-4, 6:-6]
            assert np.abs(got[sl] - expect[sl]).max() < 2e-2 * (izmin - izmax)
    for bad in (dict(position=[0.0, 0.02, 0.0]),
                dict(position=[0.02, 0.0, 0.0], focal_px=0.7 * w)):
        cam = lif_tpu_torch.Camera.create(w, h, **{"focal_px": 0.78 * w,
                                                   **bad})
        with pytest.raises(ValueError, match="render_depth_fast"):
            lif_tpu_torch.render_depth_fast(tp, cam)


@pytest.mark.parametrize("refine", [0, 2])
def test_skip_mirror_on_a_preshifted_source(rng, refine):
    """The lateral kernel's walk on the source the skew fold gives it (a
    fractional y pre-shift before the crop of an outpainted layer, x in
    the snap phase and warp offset): march_translation_skip_plain, which
    builds its row tables from that source, equals the dense plain march
    bit for bit, and so does the walk over the row tables of the cached
    _march_pack; row tables of the unshifted texture would be others."""
    from lif_tpu_torch.ops.cuda.sweep_march import (
        _pick_tw, lateral_kernel_inputs, prepare_translation_src)

    h, w = 48, 64
    rgb, disp = _scene(rng, h + 8, w)
    disp[: h // 3] = 0.2  # a far band: runs the walk can skip
    mask = np.ones_like(disp)
    tex = [torch.from_numpy(a) for a in (rgb, disp, mask)]
    f1, izmin, izmax = 0.78 * w, 2.0, 0.1
    d = -f1 * (np.array([0.017, -0.0191]) - np.array([0.0, 0.0]))
    lay = dict(rgb=tex[0], disp=tex[1], mask=tex[2], doff=(d[0], d[1]),
               izmin_host=izmin, izmax_host=izmax,
               skip_rows=tsm.row_skip_tables(tex[1], izmin, izmax)[1:],
               march_packs=trenderer.OrderedDict())
    plan = tsm.translation_plan(w, h, w, h, f1 * 0.06 * izmin + abs(d[0])
                                + 1.0, 0.0)
    pack = trenderer._march_pack(lay, plan, 4)
    assert trenderer._march_pack(lay, plan, 4) is pack  # cached
    srcs, prep, rows = pack
    for a, b in zip(srcs, trenderer._march_sources(lay, plan, 4)):
        assert torch.equal(a, b)
    assert not torch.equal(srcs[1], tex[1][4 : 4 + h])
    assert torch.equal(prep[0], prepare_translation_src(*srcs, plan)[0])
    stale = tuple(t[4 : 4 + h] for t in lay["skip_rows"])
    assert not all(torch.equal(a, b) for a, b in zip(rows, stale))
    for cx in (0.03, -0.045, 0.06):
        planes, k = tsm.snap_plane_table(f1, cx, izmin, izmax,
                                         phase_px=float(d[0]))
        c1 = np.array([cx, 0.0, 0.0], np.float32)
        dense = tsm.march_translation_plain(*srcs, izmin, izmax, c1, f1,
                                            planes, plan, k, refine=refine,
                                            offset=lay["doff"])
        mirror = tsm.march_translation_skip_plain(
            *srcs, izmin, izmax, c1, f1, planes, plan, k, refine=refine,
            offset=lay["doff"])
        for a, b in zip(dense, mirror):
            assert torch.equal(a, b)
        args = lateral_kernel_inputs(
            prepare_translation_src(*srcs, plan), izmin, izmax, c1[None],
            f1, torch.as_tensor(planes)[None], plan, k,
            offset=(lay["doff"][0], 0.0))
        kstar, pdc, dc = tsm.lateral_skip_walk(
            args[0], args[1][0], args[2][0], args[3][0], args[4][0],
            args[5][0], izmin, izmax, plan.pad_lo_x, _pick_tw(w), rows)
        walked = tsm.lateral_bracket(args[0], args[1][0], args[2][0],
                                     args[3][0], kstar, pdc, dc, izmin,
                                     izmax, plan.pad_lo_x, refine=refine)
        for a, b in zip(dense, walked):
            assert torch.equal(a, b)
        assert dense[0].mean().item() > 0.3
