"""The lateral march's uniform and hybrid plane grids
(RenderConfig.plane_mode) against lif_tpu (CPU).

The same seeded scene goes through lif_tpu (JAX on the CPU: the XLA twin
of its lateral kernel) and, carried across with projector_from_reference,
through lif_tpu_torch (the plain march on CPU tensors), on every lateral
path: render_fast_batch, render_fast_view, render(mode='fast' |
'stereo_fast'), render_stereo_fast_batch and render_fused_fast_batch.
Gates: max abs < 3e-5 in linear light and < 1e-4 in sRGB (the lateral
march's gate, tests/test_torch_render.py); fusion outside the pixels
where a projector's alpha is 0 in one package and not in the other
(tests/test_torch_fusion.py). At march_planes=32 the uniform grid differs
from the snap grid by about 1e-3, so a render that silently took the
snap grid fails.
"""

import numpy as np
import pytest
import torch

import lif_tpu
import lif_tpu_torch
from lif_tpu.models import renderer as jrenderer
from lif_tpu_torch.models import renderer as trenderer

from .scenes import make_layer, smooth_noise
from .test_torch_fusion import _assert_fast_gate, _both, _case
from .test_torch_fusion import _cams as _fused_cams
from .test_torch_stereo_fast import _lif_tpu_stereo, _pair

torch.set_num_threads(1)

K_SMALL = 32  # march_planes at which the grids tell apart
SNAP_GAP = 1e-4  # the least max abs between a mode's frame and snap's
XS = [0.02, 0.035, 0.05]


def _cfg(pkg, mode, **kw):
    return pkg.DEFAULT_CONFIG.replace(plane_mode=mode, **kw)


def _scene(rng, h, w):
    """Smooth noise plus a hard near box (tests/test_torch_render.py)."""
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


def _cams(pkg, w, h, xs, **kw):
    return [pkg.Camera.create(w, h, focal_px=0.78 * w, position=[x, 0.0, 0.0],
                              **kw) for x in xs]


def _batch(pkg, proj, xs, mode, w=128, h=64, **kw):
    out = pkg.render_fast_batch(
        proj, _cams(pkg, w, h, xs), method="march",
        config=_cfg(pkg, mode, march_planes=K_SMALL), return_tiers=True, **kw)
    return np.asarray(out[0]), tuple(out[1])


@pytest.mark.parametrize("mode", ["uniform", "hybrid"])
@pytest.mark.parametrize("to_srgb,tol", [(False, 3e-5), (True, 1e-4)])
def test_fast_batch_plane_modes_match_lif_tpu(rng, mode, to_srgb, tol):
    """render_fast_batch(method='march') on the uniform and hybrid grids
    of 32 planes equals lif_tpu's, tiers ('march',); the frames are not
    the snap grid's."""
    jp, tp = _projectors(rng)
    kw = dict(to_srgb=to_srgb, background=(0.1, 0.2, 0.3, 1.0))
    ref, jtiers = _batch(lif_tpu, jp, XS, mode, **kw)
    got, ttiers = _batch(lif_tpu_torch, tp, XS, mode, **kw)
    assert jtiers == ttiers == ("march",)
    assert got.shape == ref.shape == (3, 64, 128, 4)
    assert np.abs(got - ref).max() < tol
    snap, _ = _batch(lif_tpu_torch, tp, XS, "snap", **kw)
    assert np.abs(got - snap).max() > SNAP_GAP


@pytest.mark.parametrize("mode", ["uniform", "hybrid"])
def test_explicit_num_planes(rng, mode):
    """num_planes=48 overrides config.march_planes on both packages."""
    jp, tp = _projectors(rng)
    ref = np.asarray(lif_tpu.render_fast_batch(
        jp, _cams(lif_tpu, 128, 64, XS), method="march", num_planes=48,
        to_srgb=False, config=_cfg(lif_tpu, mode)))
    got = lif_tpu_torch.render_fast_batch(
        tp, _cams(lif_tpu_torch, 128, 64, XS), method="march", num_planes=48,
        to_srgb=False, config=_cfg(lif_tpu_torch, mode))
    assert np.abs(got.numpy() - ref).max() < 3e-5
    other = lif_tpu_torch.render_fast_batch(
        tp, _cams(lif_tpu_torch, 128, 64, XS), method="march", to_srgb=False,
        config=_cfg(lif_tpu_torch, mode, march_planes=K_SMALL))
    assert float((got - other).abs().max()) > SNAP_GAP


def _ldi(rng, h=64, w=128):
    """Three LDI layers, the back two outpainted (taller and wider by even
    margins), the front one masked."""
    rgb0, disp0 = _scene(rng, h, w)
    mask0 = (smooth_noise(rng, h, w, octaves=2) > 0.35).astype(np.float32)
    mid = make_layer(rng, h + 16, w + 32, invz_min=0.8, invz_max=0.3,
                     with_mask=True)
    back = make_layer(rng, h + 32, w + 64, invz_min=0.5, invz_max=0.1)
    jp = lif_tpu.projector_from_arrays(
        rgb0, disp0, mask0, focal_px=0.78 * w, invz_min=2.0, invz_max=0.6,
        baseline=1.0,
        extra_layers=[dict(rgb=lay["rgb"], disp=lay["disp"],
                           mask=lay.get("mask"), focal_px=0.78 * w,
                           invz_min=lo, invz_max=hi)
                      for lay, lo, hi in ((mid, 0.8, 0.3),
                                          (back, 0.5, 0.1))],
    )
    return jp, lif_tpu_torch.projector_from_reference(jp, device="cpu")


# case: (h, w, projector, camera kwargs)
_VIEW_CASES = {
    "skewed": (64, 128, lambda rng: _projectors(rng, skew=(0.03, -0.0213)),
               dict(position=[0.05, 0.0, 0.0], skew=(0.01, 0.005))),
    "odd_width": (64, 127, lambda rng: _projectors(rng, w=127),
                  dict(position=[0.05, 0.0, 0.0])),
    "ldi": (64, 128, _ldi, dict(position=[0.04, 0.0, 0.0])),
}


@pytest.mark.parametrize("case", sorted(_VIEW_CASES))
@pytest.mark.parametrize("mode", ["uniform", "hybrid"])
def test_fast_view_plane_modes_match_lif_tpu(rng, case, mode):
    """render_fast_view on the uniform and hybrid grids: a skewed camera
    under a skewed projector (the fold's constant shift on a grid with no
    phase), an odd width (the pad's wpad/2 offset) and a 3-layer LDI, two
    layers outpainted (crop_y); equal to lif_tpu's, and render(mode=
    'fast') is the same frame."""
    h, w, make, ckw = _VIEW_CASES[case]
    jp, tp = make(rng)
    jcfg, tcfg = (_cfg(pkg, mode, march_planes=K_SMALL)
                  for pkg in (lif_tpu, lif_tpu_torch))
    ref = np.asarray(jrenderer.render_fast_view(
        jp, lif_tpu.Camera.create(w, h, focal_px=0.78 * w, **ckw),
        to_srgb=False, config=jcfg))
    cam = lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w, **ckw)
    got = lif_tpu_torch.render_fast_view(tp, cam, to_srgb=False, config=tcfg)
    assert got.shape == (h, w, 4)
    assert np.abs(got.numpy() - ref).max() < 3e-5
    via = lif_tpu_torch.render(tp, cam, mode="fast", to_srgb=False,
                               config=tcfg)
    assert torch.equal(via, got)


def test_stereo_uniform_on_an_ldi_pair(rng):
    """render_stereo_fast_batch on the uniform grid for a masked 2-layer
    LDI pair (the hard mode: each eye marches its eroded mask); tiers
    ('march', 'march') per eye, equal to lif_tpu's; render(mode=
    'stereo_fast') is the same frame."""
    (jl, tl), (jr, tr) = _pair(rng, 64, 96, 0.03, with_mask=True)
    poses = [([0.005, 0, 0], None), ([-0.012, 0, 0], None)]
    jcams = [lif_tpu.Camera.create(96, 64, focal_px=0.78 * 96, position=p)
             for p, _ in poses]
    tcams = [lif_tpu_torch.Camera.create(96, 64, focal_px=0.78 * 96,
                                         position=p) for p, _ in poses]
    jcfg, tcfg = (_cfg(pkg, "uniform", march_planes=K_SMALL)
                  for pkg in (lif_tpu, lif_tpu_torch))
    ref, jtiers = _lif_tpu_stereo(jl, jr, jcams, to_srgb=False, config=jcfg)
    got, ttiers = lif_tpu_torch.render_stereo_fast_batch(
        tl, tr, tcams, to_srgb=False, config=tcfg, return_tiers=True)
    assert jtiers == ttiers == (("march", "march"),) * 2
    assert np.abs(got.numpy() - ref).max() < 3e-5
    snap = lif_tpu_torch.render_stereo_fast_batch(tl, tr, tcams,
                                                  to_srgb=False)
    assert float((got - snap).abs().max()) > SNAP_GAP
    via = lif_tpu_torch.render([tl, tr], tcams[1], mode="stereo_fast",
                               to_srgb=False, config=tcfg)
    assert torch.equal(via, got[1])


def test_fused_hybrid(rng):
    """render_fused_fast_batch on the hybrid grid, an LDI projector beside
    a single layer: lif_tpu's frames outside the alpha-flip pixels (the
    fast gate of tests/test_torch_fusion.py, its flips found on the same
    grid)."""
    projs, positions, skew = _case("ldi_and_single", rng)
    pairs = [_both(kw) for kw in projs]
    jcams, tcams = _fused_cams(positions, skew)
    jps, tps = zip(*pairs)
    jcfg, tcfg = (_cfg(pkg, "hybrid", march_planes=K_SMALL)
                  for pkg in (lif_tpu, lif_tpu_torch))
    ref = np.asarray(lif_tpu.render_fused_fast_batch(jps, jcams,
                                                     config=jcfg))
    got = lif_tpu_torch.render_fused_fast_batch(tps, tcams, config=tcfg)
    flips = None
    for (jp, tp) in pairs:
        mode = "multiply" if jp.num_layers > 1 else "none"
        kw = dict(to_srgb=False, background=(0.0, 0.0, 0.0, 0.0),
                  mask_mode=mode)
        ja = np.asarray(lif_tpu.render_fast_batch(
            jp, jcams, config=jcfg, **kw))[..., 3]
        ta = lif_tpu_torch.render_fast_batch(
            tp, tcams, config=tcfg, **kw)[..., 3].numpy()
        f = (ja > 0.0) != (ta > 0.0)
        flips = f if flips is None else flips | f
    _assert_fast_gate(got.numpy(), ref, flips)
    snap = lif_tpu_torch.render_fused_fast_batch(tps, tcams)
    assert float((got - snap).abs().max()) > SNAP_GAP


def test_uniform_beyond_one_kernel_segment(rng):
    """A uniform grid of 1536 planes (beyond the CUDA kernel's 1024-plane
    shared-memory segment) renders on the CPU path equal to lif_tpu's."""
    jp, tp = _projectors(rng, h=32, w=64)
    xs = [0.03]
    kw = dict(method="march", to_srgb=False)
    ref = np.asarray(lif_tpu.render_fast_batch(
        jp, _cams(lif_tpu, 64, 32, xs),
        config=_cfg(lif_tpu, "uniform", march_planes=1536), **kw))
    got = lif_tpu_torch.render_fast_batch(
        tp, _cams(lif_tpu_torch, 64, 32, xs),
        config=_cfg(lif_tpu_torch, "uniform", march_planes=1536), **kw)
    assert np.abs(got.numpy() - ref).max() < 3e-5


def test_depth_fast_keeps_the_snap_grid(rng):
    """render_depth_fast marches the snap grid whatever plane_mode says,
    as lif_tpu's does: equal across modes and to lif_tpu's."""
    jp, tp = _projectors(rng)
    cam = _cams(lif_tpu_torch, 128, 64, [0.04])[0]
    snap = lif_tpu_torch.render_depth_fast(tp, cam)
    for mode in ("uniform", "hybrid"):
        got = lif_tpu_torch.render_depth_fast(
            tp, cam, config=_cfg(lif_tpu_torch, mode, march_planes=K_SMALL))
        assert torch.equal(got, snap)
    ref = np.asarray(lif_tpu.render_depth_fast(
        jp, _cams(lif_tpu, 128, 64, [0.04])[0],
        config=_cfg(lif_tpu, "uniform", march_planes=K_SMALL)))
    assert np.abs(snap.numpy() - ref).max() < 3e-5


def _entry(pkg, rng_seed, what):
    """A call of one lateral entry point of `pkg` under plane_mode
    'bogus'."""
    rng = np.random.default_rng(rng_seed)
    proj = _projectors(rng, h=32, w=64)[0 if pkg is lif_tpu else 1]
    cam = _cams(pkg, 64, 32, [0.02])[0]
    cfg = _cfg(pkg, "bogus")
    if what == "batch":
        return lambda: pkg.render_fast_batch(proj, [cam], config=cfg)
    if what == "view":
        return lambda: pkg.render_fast_view(proj, cam, config=cfg)
    if what == "stereo":
        return lambda: pkg.render_stereo_fast_batch(proj, proj, [cam],
                                                    config=cfg)
    return lambda: pkg.render_fused_fast_batch([proj, proj], [cam],
                                               config=cfg)


@pytest.mark.parametrize("what", ["batch", "view", "stereo", "fused"])
def test_unknown_plane_mode_raises_like_lif_tpu(what):
    """An unknown plane_mode raises lif_tpu's ValueError text on every
    lateral entry point."""
    with pytest.raises(ValueError) as jerr:
        _entry(lif_tpu, 0, what)()
    with pytest.raises(ValueError) as terr:
        _entry(lif_tpu_torch, 0, what)()
    assert str(terr.value) == str(jerr.value) == "unknown plane mode: bogus"


def test_plane_mode_changes_between_calls(rng):
    """Changing plane_mode or march_planes between calls on one projector
    gives the frames a fresh cache gives: each table is keyed on (K,
    mode), and the snap ladders, march packs and texture entries are
    shared only where they hold."""
    _, tp = _projectors(rng)
    cams = _cams(lif_tpu_torch, 128, 64, XS)
    steps = [("snap", 256), ("uniform", K_SMALL), ("hybrid", K_SMALL),
             ("uniform", 48), ("snap", 256), ("uniform", K_SMALL)]
    frames = []
    for mode, k in steps:
        cfg = _cfg(lif_tpu_torch, mode, march_planes=k)
        frames.append(lif_tpu_torch.render_fast_batch(tp, cams, config=cfg,
                                                      to_srgb=False))
    for (mode, k), got in zip(steps, frames):
        for cache in (trenderer._TEX_CACHE, trenderer._TABLE_CACHE,
                      trenderer._PLANE_TABLE_CACHE):
            cache.clear()
        fresh = lif_tpu_torch.render_fast_batch(
            tp, cams, config=_cfg(lif_tpu_torch, mode, march_planes=k),
            to_srgb=False)
        assert torch.equal(got, fresh), (mode, k)
    assert torch.equal(frames[0], frames[4])
    assert torch.equal(frames[1], frames[5])
    assert float((frames[1] - frames[3]).abs().max()) > SNAP_GAP
    assert float((frames[1] - frames[2]).abs().max()) > SNAP_GAP
