"""The port's lateral slice end to end against lif_tpu (CPU).

The same seeded scene goes through lif_tpu.render_fast_batch (JAX on the
CPU: its XLA oracle of the march) and, carried across with
projector_from_reference, through lif_tpu_torch.render_fast_batch (the
plain twin on CPU tensors). Gate: max abs < 3e-5 in linear light (the
kernel-vs-twin gate of tests/test_sweep_march.py), < 1e-4 in sRGB (the
gamma curve's slope near 0 magnifies float32 noise).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

import lif_tpu
import lif_tpu_torch
from lif_tpu_torch.models import renderer as trenderer

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


def _cams(pkg, w, h, xs, f=None, **kw):
    f = 0.78 * w if f is None else f
    return [pkg.Camera.create(w, h, focal_px=f, position=[x, 0.0, 0.0], **kw)
            for x in xs]


def _psnr(a, b):
    mse = np.mean((a[..., :3] - b[..., :3]) ** 2)
    return 10 * np.log10(1.0 / max(mse, 1e-12))


@pytest.mark.parametrize("to_srgb,tol", [(False, 3e-5), (True, 1e-4)])
def test_fast_batch_matches_lif_tpu(rng, to_srgb, tol):
    """The slice: render_fast_batch(method='march') equals lif_tpu's on the
    same scene and poses; tiers are ('march',)."""
    jp, tp = _projectors(rng)
    xs = [0.02, 0.035, 0.05]
    bg = (0.1, 0.2, 0.3, 1.0)
    ref = np.asarray(lif_tpu.render_fast_batch(
        jp, _cams(lif_tpu, 128, 64, xs), method="march", to_srgb=to_srgb,
        background=bg,
    ))
    got, tiers = lif_tpu_torch.render_fast_batch(
        tp, _cams(lif_tpu_torch, 128, 64, xs), method="march",
        to_srgb=to_srgb, background=bg, return_tiers=True,
    )
    assert tiers == ("march",)
    assert got.shape == ref.shape == (3, 64, 128, 4)
    assert np.abs(got.numpy() - ref).max() < tol


def test_pose_chunks_and_batch_equal_per_pose(rng):
    """pose_chunk=2 splits 3 poses into balanced chunks of 2 + 1; the
    result equals the unchunked batch and each single-pose render, and
    lif_tpu's chunked render."""
    jp, tp = _projectors(rng)
    xs = [0.015, 0.03, 0.045]
    cams = _cams(lif_tpu_torch, 128, 64, xs)
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=2)
    whole = lif_tpu_torch.render_fast_batch(tp, cams)
    chunked = lif_tpu_torch.render_fast_batch(tp, cams, config=cfg)
    assert torch.equal(whole, chunked)
    for i, cam in enumerate(cams):
        single = lif_tpu_torch.render_fast_batch(tp, [cam])
        assert torch.equal(single[0], whole[i])
    ref = np.asarray(lif_tpu.render_fast_batch(
        jp, _cams(lif_tpu, 128, 64, xs), config=cfg,
    ))
    assert np.abs(chunked.numpy() - ref).max() < 1e-4


def test_odd_width_pad_and_slice_march(rng):
    """A non-8-divisible width marches a padded band with a wpad/2 offset
    and slices the true width (tests/test_sweep_march.py's case): equal
    to lif_tpu, and >= 42 dB against the exact march."""
    h, w = 96, 127
    jp, tp = _projectors(rng, h=h, w=w)
    xs = [0.05, 0.06, 0.07]
    ref = np.asarray(lif_tpu.render_fast_batch(
        jp, _cams(lif_tpu, w, h, xs), method="march"))
    cams = _cams(lif_tpu_torch, w, h, xs)
    got = lif_tpu_torch.render_fast_batch(tp, cams, method="march").numpy()
    assert got.shape == (3, h, w, 4)
    assert np.abs(got - ref).max() < 1e-4
    exact = lif_tpu_torch.render_mono_view(
        tp, cams[0], mask_mode="none", num_steps=320).numpy()
    sl = np.s_[8:-8, 8:-8]
    assert _psnr(got[0][sl], exact[sl]) > 42.0


def test_ldi_outpainted_layers_match(rng):
    """Two LDI layers, the back one outpainted (taller and wider by even
    margins: center-cropped with the taper in uncropped layer space),
    with masks: equal to lif_tpu's front-to-back composite."""
    h, w = 64, 128
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
    xs = [0.03, 0.06]
    ref = np.asarray(lif_tpu.render_fast_batch(
        jp, _cams(lif_tpu, w, h, xs), method="march", to_srgb=False))
    got, tiers = lif_tpu_torch.render_fast_batch(
        tp, _cams(lif_tpu_torch, w, h, xs), method="march", to_srgb=False,
        return_tiers=True)
    assert tiers == ("march", "march")
    assert np.abs(got.numpy() - ref).max() < 3e-5


def test_raycast_mode_matches_lif_tpu(rng):
    """render(mode='raycast') == lif_tpu's exact march to >= 60 dB."""
    jp, tp = _projectors(rng, h=48, w=64)
    ref = np.asarray(lif_tpu.render(jp, _cams(lif_tpu, 64, 48, [0.04])[0]))
    got = lif_tpu_torch.render(tp, _cams(lif_tpu_torch, 64, 48, [0.04])[0])
    assert _psnr(got.numpy(), ref) > 60.0


def _roty_rad(a):
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]])


def _case_camera(pkg, case, beyond=False):
    """The 64x32 camera of a test case; beyond=True moves a rotation,
    translation or focal case past every march tier's budget (a batch
    lif_tpu sends to its sweep fallback)."""
    pos, rot, focal, skew = [0.03, 0.0, 0.0], None, 0.78 * 64, (0.0, 0.0)
    if case == "rotated":
        rot = (_roty_rad(np.deg2rad(25.0)) @ np.array(
            [[1, 0, 0], [0, np.cos(0.436), -np.sin(0.436)],
             [0, np.sin(0.436), np.cos(0.436)]]) if beyond
               else _roty_rad(0.05))
        pos = [0.0, 0.0, 0.0] if beyond else pos
    elif case == "y_translation":
        pos = [0.0, 10.0 if beyond else 0.03, 0.0]
    elif case == "z_translation":
        pos = [0.03, 0.0, 0.5 if beyond else 0.1]
    elif case == "skewed":
        skew = (0.02, 0.0)
    elif case == "focal_mismatch":
        focal = (0.2 if beyond else 0.9) * 64
    return pkg.Camera.create(64, 32, focal_px=focal, position=pos,
                             rotation=rot, skew=skew)


_FORMERLY_UNCOVERED = {"rotated": "rotated", "y_translation": "scaled",
                       "z_translation": "scaled", "focal_mismatch": "scaled",
                       "skewed": "march"}


@pytest.mark.parametrize("case", ["uniform_planes", "stereo_mode"])
def test_uncovered_poses_raise_not_implemented(rng, case):
    """What no ported tier covers raises NotImplementedError naming what it
    needs; it never returns a silent wrong image: the mono batch and the
    stereo fast path have only the snap grid of the march (lif_tpu's
    uniform and hybrid march grids are not ported)."""
    _, tp = _projectors(rng, h=32, w=64)
    kw = dict(config=lif_tpu_torch.DEFAULT_CONFIG.replace(
        plane_mode="uniform"))
    cam = _case_camera(lif_tpu_torch, case)
    with pytest.raises(NotImplementedError, match="snap"):
        if case == "stereo_mode":
            lif_tpu_torch.render([tp, tp], cam, mode="stereo_fast", **kw)
        else:
            lif_tpu_torch.render_fast_batch(tp, [cam], **kw)


def _fallback_warnings(fn):
    """fn()'s result and the messages of the TierFallbackWarnings it fired
    (each package's own class)."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn()
    fired = [str(r.message) for r in rec
             if r.category.__name__ == "TierFallbackWarning"]
    return out, fired


@pytest.mark.parametrize("case", [
    "rotated", "y_translation", "z_translation", "focal_mismatch",
    "sweep_method",
])
def test_sweep_poses_match_lif_tpu(rng, case):
    """A rotation, a y/z translation or a mismatched focal past every march
    tier's budget is lif_tpu's 'sweep' fallback, and method='sweep' sweeps
    a lateral batch: each renders on the 'sweep' tier in both packages,
    with lif_tpu's image and lif_tpu's TierFallbackWarning (the same text;
    none for method='sweep', which asked for the sweep). Gate: max abs
    < 2e-3 in sRGB; lif_tpu's colour row product rounds to bf16, where
    the two packages' products, summed in another order, can round one
    bf16 step (2^-8 relative) apart."""
    jp, tp = _projectors(rng, h=32, w=64)
    beyond = case != "sweep_method"
    kw = {} if beyond else dict(method="sweep")
    (ref, jt), jw = _fallback_warnings(lambda: lif_tpu.render_fast_batch(
        jp, [_case_camera(lif_tpu, case, beyond)], return_tiers=True, **kw))
    (got, tt), tw = _fallback_warnings(
        lambda: lif_tpu_torch.render_fast_batch(
            tp, [_case_camera(lif_tpu_torch, case, beyond)],
            return_tiers=True, **kw))
    assert tuple(jt) == tt == ("sweep",)
    assert tw == jw and len(tw) == int(beyond)
    assert beyond == ("plane-sweep" in "".join(tw))
    assert np.abs(got.numpy() - np.asarray(ref)).max() < 2e-3


@pytest.mark.parametrize("case", sorted(_FORMERLY_UNCOVERED))
def test_formerly_uncovered_poses_match_lif_tpu(rng, case):
    """The poses that raised before the scaled and rotated tiers and the
    skewed lateral fold were ported (a rotation at a width the target
    tier rejects, y/z translation, a mismatched focal, a skewed camera at
    a lateral pose) render on the tier lif_tpu picks, with lif_tpu's
    image."""
    jp, tp = _projectors(rng, h=32, w=64)
    ref, jt = lif_tpu.render_fast_batch(jp, [_case_camera(lif_tpu, case)],
                                        return_tiers=True)
    got, tt = lif_tpu_torch.render_fast_batch(
        tp, [_case_camera(lif_tpu_torch, case)], return_tiers=True)
    assert tuple(jt) == tt == (_FORMERLY_UNCOVERED[case],)
    assert _psnr(got.numpy(), np.asarray(ref)) >= 60.0


def test_texture_cache_tracks_in_place_writes(rng):
    """The texture cache keys on the tensors' version counters: an
    in-place write to the disparity re-prepares, a repeat call hits."""
    _, tp = _projectors(rng, h=32, w=64)
    a = trenderer._prepared_textures(tp)
    assert trenderer._prepared_textures(tp) is a
    tp.disp.mul_(0.5)
    b = trenderer._prepared_textures(tp)
    assert b is not a


def test_texture_cache_keys_on_host_fields(rng):
    """A projector made with dataclasses.replace keeps the first one's
    texture tensors; with invz_min doubled it must render as a freshly
    built projector with that range does (the seeded 64x96 scene, one
    lateral pose at x = 0.3), not as the cached first one: the texture
    cache keys on the host fields its entries bake in."""
    h, w = 64, 96
    rgb, disp = _scene(rng, h, w)
    kw = dict(focal_px=0.78 * w, invz_max=0.1, baseline=1.0, device="cpu")
    first = lif_tpu_torch.projector_from_arrays(rgb, disp, invz_min=2.0, **kw)
    cams = _cams(lif_tpu_torch, w, h, [0.3])
    before = lif_tpu_torch.render_fast_batch(first, cams)
    moved = dataclasses.replace(first, invz_min=first.invz_min * 2)
    fresh = lif_tpu_torch.projector_from_arrays(rgb, disp, invz_min=4.0,
                                                **kw)
    got = lif_tpu_torch.render_fast_batch(moved, cams)
    assert torch.equal(got, lif_tpu_torch.render_fast_batch(fresh, cams))
    assert (got - before).abs().max().item() > 0.1


def test_sweep_table_cache_keys_on_layer_res(rng):
    """The sweep's plane tables are built from the disparity sliced to
    layer_res: a dataclasses.replace projector whose layer 0 is 48x64 of
    the first one's 96x64 tensor must render (method='sweep', K = 16, one
    lateral pose at x = 0.1) as it does with fresh caches, not with the
    first projector's tables (lif_tpu keeps this fault:
    lif_tpu/models/renderer.py:242-248)."""
    h, w = 64, 96
    disp = rng.random((h, w)).astype(np.float32)
    disp[:, w // 2:] = 0.9
    rgb = rng.random((h, w, 3)).astype(np.float32)
    first = lif_tpu_torch.projector_from_arrays(
        rgb, disp, focal_px=0.78 * w, invz_min=2.0, invz_max=0.1,
        baseline=1.0, device="cpu")
    cams = _cams(lif_tpu_torch, w, h, [0.1])
    kw = dict(method="sweep", num_planes=16)
    before = lif_tpu_torch.render_fast_batch(first, cams, **kw)
    half = dataclasses.replace(
        first, layer_res=np.asarray([[w // 2, h]], np.float32))
    got = lif_tpu_torch.render_fast_batch(half, cams, **kw)
    trenderer._PLANE_TABLE_CACHE.clear()
    trenderer._TEX_CACHE.clear()
    fresh = lif_tpu_torch.render_fast_batch(half, cams, **kw)
    assert torch.equal(got, fresh)
    assert (got - before).abs().max().item() > 0.1


def test_texture_cache_holds_the_kernels_skip_tables(rng):
    """The march kernels' skip tables are cached per CUDA texture only: a
    CPU layer carries none, since its plain marches read none. The cached
    scaled pack reuses the target kernel's buffer, which equals the
    scaled kernel's own build through a rising decode; through a falling
    one skip_pack builds its own. On the card, tests/test_torch_cuda.py
    holds the cache entry to each kernel's builder."""
    from lif_tpu_torch.ops import sweep_scaled as tss
    from lif_tpu_torch.ops.cuda import sweep_target as tct

    _, tp = _projectors(rng, h=32, w=64)
    lay = trenderer._prepared_textures(tp)[0]
    assert not {"skip_target", "skip_scaled", "skip_rows"} & set(lay)
    d = lay["disp"]
    assert trenderer._layer_skip(d, 2.0, 0.1) == {}
    for izmin, izmax in ((2.0, 0.1), (0.1, 2.0)):
        target = tct.skip_table_buffer(d)
        flat, dlim = tss.skip_pack(d, izmin, izmax, target=target)
        want = tss.skip_pack(d, izmin, izmax)
        assert torch.equal(flat, want[0]) and torch.equal(dlim, want[1])
        assert (flat is target) == (izmin > izmax)
