"""The fast stereo path against lif_tpu (CPU): render_stereo_fast_batch,
render_stereo_fast, render(mode='stereo' | 'stereo_fast'), the viewer's
--render stereo and the march-pack key.

The same seeded pairs (tests/test_stereo_fast.py's) go through lif_tpu
(JAX on the CPU, the XLA twins of its tiers) and, carried across with
projector_from_reference, through lif_tpu_torch on CPU tensors (the plain
twins). Each eye's tiers must equal lif_tpu's (read from the statics of
its stereo core). Gate (tests/test_torch_orbit.py's): PSNR >= 60 dB
against lif_tpu's frame and at most 0.1% of the pixels off by more than
1e-3; fill decisions at the a < a' - 0.1 and confidence thresholds can
flip under XLA's FMA contraction (ROADMAP §3), and the gate counts them.
Fast against exact is held to lif_tpu's own bars.
"""

import numpy as np
import pytest
import torch

import lif_tpu
import lif_tpu_torch
from lif_tpu.models import renderer as jrenderer
from lif_tpu_torch.apps import viewer
from lif_tpu_torch.models import renderer as trenderer

from .scenes import make_layer
from .test_torch_api import make_lif

torch.set_num_threads(1)


def _projectors(layers, x, skew=(0.0, 0.0)):
    """A lif_tpu projector at (x, 0, 0) from make_layer dicts, the base
    view maskless and each further layer with its mask (as
    tests/test_stereo_fast.py builds its LDI), and the port's copy on CPU
    tensors."""
    def arr(layer, key):
        return np.asarray(layer[key], np.float32)

    base = layers[0]
    jp = lif_tpu.projector_from_arrays(
        arr(base, "rgb"), arr(base, "disp"), focal_px=base["focal"],
        invz_min=base["invz_min"], invz_max=base["invz_max"], baseline=1.0,
        position=(x, 0.0, 0.0), skew=skew,
        extra_layers=[dict(rgb=arr(l, "rgb"), disp=arr(l, "disp"),
                           mask=arr(l, "mask"), focal_px=l["focal"],
                           invz_min=l["invz_min"], invz_max=l["invz_max"])
                      for l in layers[1:]] or None,
    )
    return jp, lif_tpu_torch.projector_from_reference(jp, device="cpu")


def _pair(rng, h, w, eye, with_mask=False, skew=(0.0, 0.0), src=None,
          focal=None):
    """tests/test_stereo_fast.py's pair: one layer each, or with_mask a
    2-layer LDI (the second layer the first flipped, with a masked base);
    src=(sh, sw) outpaints the layers. Returns ((jl, tl), (jr, tr))."""
    sh, sw = src or (h, w)
    out = []
    for x in (-eye, eye):
        layer = make_layer(rng, sh, sw, with_mask=with_mask,
                           focal=focal or 0.78 * w)
        layers = [layer]
        if with_mask:
            layers.append(dict(layer, rgb=layer["rgb"][::-1].copy(),
                               invz_min=layer["invz_min"] * 0.8))
        out.append(_projectors(layers, x, skew))
    return out


def _lif_tpu_stereo(jl, jr, cams, **kw):
    """lif_tpu's render_stereo_fast_batch and the per-eye tiers its core
    was compiled for."""
    seen = {}
    real = jrenderer._stereo_fast_core_jit

    def spy(**statics):
        seen["tiers"] = (tuple(statics["modes_l"]), tuple(statics["modes_r"]))
        return real(**statics)

    jrenderer._stereo_fast_core_jit = spy
    try:
        out = np.asarray(lif_tpu.render_stereo_fast_batch(jl, jr, cams, **kw))
    finally:
        jrenderer._stereo_fast_core_jit = real
    return out, seen["tiers"]


def _psnr(a, b):
    mse = np.mean((np.asarray(a)[..., :3] - np.asarray(b)[..., :3]) ** 2)
    return 10 * np.log10(1.0 / max(float(mse), 1e-12))


def _assert_gate(got, ref):
    assert got.shape == ref.shape
    assert _psnr(got, ref) >= 60.0
    assert (np.abs(got - ref).max(-1) > 1e-3).mean() <= 1e-3


def _cams(pkg, w, h, poses, skew=(0.0, 0.0), focal=None):
    return [pkg.Camera.create(w, h, focal_px=focal or 0.78 * w, position=p,
                              rotation=r, skew=skew) for p, r in poses]


# case: (h, w, pair kwargs, camera poses, camera skew, tiers of each eye)
_YAW = lif_tpu.orbit_pose([0, 0, -1], 1.0, 0.05)
_CASES = {
    "lateral": (64, 96, {}, [([0.01, 0, 0], None), ([-0.02, 0, 0], None)],
                (0.0, 0.0), ("march",)),
    "skewed_lateral": (64, 96, dict(skew=(0.021, -0.0137)),
                       [([0.01, 0, 0], None), ([-0.015, 0, 0], None)],
                       (0.004, 0.0061), ("march",)),
    "ldi_masked": (64, 96, dict(with_mask=True), [([0.005, 0, 0], None)],
                   (0.0, 0.0), ("march", "march")),
    "outpainted": (64, 96, dict(src=(80, 128)), [([0.01, 0, 0], None)],
                   (0.0, 0.0), ("march",)),
    "target": (96, 128, {}, [(_YAW[0], _YAW[1])], (0.0, 0.0), ("target",)),
    "scaled": (64, 96, {}, [([0.015, 0.02, 0.03], None)], (0.0, 0.0),
               ("scaled",)),
    "rotated": (64, 96, {}, [([0.01, 0, 0],
                              lif_tpu.orbit_pose([0, 0, -1], 1.0, 0.06,
                                                 0.04)[1])],
                (0.0, 0.0), ("rotated",)),
    "odd_margin": (64, 96, dict(src=(64, 99)), [([0.01, 0, 0], None)],
                   (0.0, 0.0), ("scaled",)),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_stereo_fast_batch_matches_lif_tpu(rng, case):
    """render_stereo_fast_batch on every route of lif_tpu's stereo eyes:
    the lateral march (plain, skewed with a fractional y pre-shift, a
    masked 2-layer LDI in the hard mode with the eroded mask, outpainted
    layers), the target tier (a yaw head pose), the scaled tier (an
    off-axis y/z pose; lateral layers the march cannot take, an odd
    outpaint margin) and the two-phase tier (yaw + pitch). Tiers equal
    lif_tpu's per eye; the frames pass the gate."""
    h, w, pkw, poses, cskew, tiers = _CASES[case]
    (jl, tl), (jr, tr) = _pair(rng, h, w, 0.03, **pkw)
    ref, jtiers = _lif_tpu_stereo(jl, jr, _cams(lif_tpu, w, h, poses, cskew),
                                  to_srgb=False)
    got, ttiers = lif_tpu_torch.render_stereo_fast_batch(
        tl, tr, _cams(lif_tpu_torch, w, h, poses, cskew), to_srgb=False,
        return_tiers=True)
    assert jtiers == ttiers == (tiers, tiers)
    _assert_gate(got.numpy(), ref)
    assert (got[..., 3] > 0.5).float().mean() > 0.5


def test_non_8_divisible_width_raises_like_lif_tpu(rng):
    """A 94-px-wide pair: no march tier takes the width (the scaled plan
    needs 8-divisible widths), so both packages raise ValueError naming
    render_stereo_view; so does a pose past every tier's budget."""
    (jl, tl), (jr, tr) = _pair(rng, 32, 94, 0.03)
    pose = [([0.01, 0, 0], None)]
    with pytest.raises(ValueError, match="render_stereo_view"):
        lif_tpu.render_stereo_fast_batch(jl, jr, _cams(lif_tpu, 94, 32, pose))
    with pytest.raises(ValueError, match="render_stereo_view"):
        lif_tpu_torch.render_stereo_fast(
            tl, tr, _cams(lif_tpu_torch, 94, 32, pose)[0])
    (_, tl), (_, tr) = _pair(rng, 32, 64, 0.03)
    far = [([0.0, 10.0, 0.0], None)]
    with pytest.raises(ValueError, match="render_stereo_view"):
        lif_tpu_torch.render_stereo_fast_batch(
            tl, tr, _cams(lif_tpu_torch, 64, 32, far))


def test_stereo_fast_batch_equals_singles_and_chunks(rng):
    """The batch equals per-pose render_stereo_fast calls
    (tests/test_stereo_fast.py:94), and pose chunks of 2 equal one chunk,
    on a masked LDI pair."""
    h, w = 48, 64
    (_, tl), (_, tr) = _pair(rng, h, w, 0.03, with_mask=True)
    cams = _cams(lif_tpu_torch, w, h, [([x, 0, 0], None)
                                       for x in (-0.02, 0.0, 0.015)])
    batch = lif_tpu_torch.render_stereo_fast_batch(tl, tr, cams)
    for i, cam in enumerate(cams):
        single = lif_tpu_torch.render_stereo_fast(tl, tr, cam)
        assert (batch[i] - single).abs().max().item() < 1e-6
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=2)
    chunked = lif_tpu_torch.render_stereo_fast_batch(tl, tr, cams, config=cfg)
    assert torch.equal(chunked, batch)


def test_stereo_fast_weight_extremes(rng):
    """At the left view's position the blend is all left away from the
    feathering band (lif_tpu's test_stereo_fast_weight_extremes, its 35
    dB bar against the left view's fast mono frame)."""
    h, w = 64, 96
    (_, tl), (_, tr) = _pair(rng, h, w, 0.04)
    cam = _cams(lif_tpu_torch, w, h, [([-0.04, 0, 0], None)])[0]
    fast = lif_tpu_torch.render_stereo_fast(tl, tr, cam, num_planes=96)
    mono = lif_tpu_torch.render_fast_view(tl, cam, num_planes=96,
                                          mask_mode="none")
    bh, bw = int(0.15 * h), int(0.15 * w)
    assert _psnr(fast[bh:-bh, bw:-bw].numpy(),
                 mono[bh:-bh, bw:-bw].numpy()) >= 35.0


# case: (h, w, pair kwargs, pose, exact steps, fast planes, crop, bar dB)
_EXACT = {
    "lateral": (96, 128, {}, [0.01, 0, 0], 160, 160, 0, 37.0),
    "ldi_masked": (96, 128, dict(with_mask=True), [0.005, 0, 0], 160, 160, 0,
                   40.0),
    "outpainted": (96, 128, dict(src=(112, 160)), [0.01, 0, 0], 160, 160, 0,
                   35.0),
}


@pytest.mark.parametrize("case", sorted(_EXACT))
def test_stereo_fast_matches_exact_at_lif_tpu_bars(rng, case):
    """Fast against the exact two-view march at lif_tpu's own bars
    (tests/test_stereo_fast.py:67, 157, 186): 37 dB single layer, 40 dB
    for the masked LDI (discard flips under 1% excluded), 35 dB with
    outpainted layers."""
    h, w, pkw, pos, steps, planes, _, bar = _EXACT[case]
    (_, tl), (_, tr) = _pair(rng, h, w, 0.03, **pkw)
    cam = _cams(lif_tpu_torch, w, h, [(pos, None)])[0]
    exact = lif_tpu_torch.render_stereo_view(tl, tr, cam,
                                             num_steps=steps).numpy()
    fast = lif_tpu_torch.render_stereo_fast(tl, tr, cam,
                                            num_planes=planes).numpy()
    keep = (exact[..., 3] <= 1e-6) == (fast[..., 3] <= 1e-6)
    assert keep.mean() > 0.99
    assert _psnr(fast[keep], exact[keep]) >= bar


def test_render_stereo_modes_dispatch(rng):
    """render(mode='stereo' | 'stereo_fast') renders the first two
    projectors with render_stereo_view / render_stereo_fast; one
    projector raises ValueError, as in lif_tpu."""
    (_, tl), (_, tr) = _pair(rng, 32, 64, 0.03)
    cam = _cams(lif_tpu_torch, 64, 32, [([0.01, 0, 0], None)])[0]
    assert torch.equal(lif_tpu_torch.render([tl, tr, tl], cam,
                                            mode="stereo_fast"),
                       lif_tpu_torch.render_stereo_fast(tl, tr, cam))
    assert torch.equal(lif_tpu_torch.render((tl, tr), cam, mode="stereo",
                                            num_steps=20),
                       lif_tpu_torch.render_stereo_view(tl, tr, cam,
                                                        num_steps=20))
    for mode in ("stereo", "stereo_fast"):
        with pytest.raises(ValueError, match="two projectors"):
            lif_tpu_torch.render(tl, cam, mode=mode)


def test_viewer_renders_stereo(rng, tmp_path):
    """The viewer's --render stereo blends the first two views of a
    2-view LIF (lif_tpu/apps/viewer.py:146-147) frame by frame on the CPU
    and writes the frames; a 1-view LIF raises the two-projector
    ValueError."""
    path = tmp_path / "pair.lif"
    path.write_bytes(_two_view_lif(rng))
    out = tmp_path / "frames"
    assert viewer.main([str(path), "--render", "stereo", "--frames", "2",
                        "--sweep", "4", "--out", str(out), "--device",
                        "cpu"]) == 0
    assert len(list(out.glob("frame_*.png"))) == 2
    one = tmp_path / "one.lif"
    one.write_bytes(make_lif(rng, w=32, h=24, stereo_data={"invd": 0.1}))
    with pytest.raises(ValueError, match="two projectors"):
        viewer.main([str(one), "--render", "stereo", "--frames", "1",
                     "--out", str(tmp_path / "x"), "--device", "cpu"])


def _two_view_lif(rng, w=32, h=24):
    """A two-view LIF with PNG payloads, the views at -+0.5 baselines
    (examples/multiview_demo.py's layout); view 0's image is the file's
    outer image."""
    from lif_tpu_torch.io import container
    from lif_tpu_torch.io.decode import encode_png

    left, right = make_layer(rng, h, w), make_layer(rng, h, w)
    view = {"width_px": w, "height_px": h, "focal_px": 0.78 * w,
            "rotation": [0.0, 0.0, 0.0]}
    meta = {
        "views": [
            dict(view, position=[-0.5, 0.0, 0.0], image={"blob_id": -1},
                 inv_z_map={"blob_id": 20, "min": 0.09, "max": 0.0001}),
            dict(view, position=[0.5, 0.0, 0.0], image={"blob_id": 30},
                 inv_z_map={"blob_id": 31, "min": 0.09, "max": 0.0001}),
        ],
        "baseline_mm": 45.0,
        "stereo_render_data": {"invd": 0.045},
    }
    blobs = {20: encode_png(left["disp"]), 30: encode_png(right["rgb"]),
             31: encode_png(right["disp"])}
    return container.write(encode_png(left["rgb"]), meta, blobs)


def test_march_pack_keys_on_the_mask(rng):
    """The lateral kernel's cached pack holds the mask it was built from:
    a layer dict with the eroded stereo mask and one with the texture's
    mask share one pack cache (one texture) and get packs of their own,
    each carrying its own mask; a repeat call hits. Keyed on (y shift,
    crop, plan) alone, the second call would get the first's pack."""
    h, w = 32, 48
    layer = make_layer(rng, h, w, with_mask=True)
    tex = [torch.from_numpy(np.asarray(layer[k], np.float32))
           for k in ("rgb", "disp", "mask")]
    lay = dict(rgb=tex[0], disp=tex[1], mask=tex[2], doff=(0.0, 0.0),
               izmin_host=2.0, izmax_host=0.2,
               march_packs=trenderer.OrderedDict())
    plan = trenderer._march_plan(dict(lay, w=w, h=h, focal_host=0.78 * w),
                                 0.05, w, h)
    eroded = trenderer._eroded_mask(lay)
    assert trenderer._eroded_mask(lay) is eroded  # computed once
    mono = trenderer._march_pack(lay, plan, 0)
    stereo = trenderer._march_pack(dict(lay, mask=eroded), plan, 0)
    assert stereo is not mono
    assert torch.equal(mono[1][0][3], tex[2])  # the stack's mask row
    assert torch.equal(stereo[1][0][3], eroded)
    assert not torch.equal(eroded, tex[2])
    assert trenderer._march_pack(lay, plan, 0) is mono
    assert trenderer._march_pack(dict(lay, mask=eroded), plan, 0) is stereo
