"""Multi-projector fusion against lif_tpu (CPU): the merge's weights,
render_fused_fast(_batch) and the exact fused oracle
parallel.sharding.render_fused_projectors.

The same seeded scenes (tests/test_fusion.py's constructions at 64x96) go
through lif_tpu (JAX on the CPU: the XLA twin of its lateral tier, and
its shard_map oracle on a 2- or 4-device virtual CPU mesh) and, carried
across with projector_from_reference, through lif_tpu_torch on CPU
tensors (the plain twin of the lateral kernel; the oracle stacked on one
device). Gates:
  * ops.composite.fusion_weights (lif_tpu's _fusion_weights): equal,
    element for element.
  * the fast form: lif_tpu's kernel-vs-twin gate, max abs < 3e-5
    (tests/test_sweep_march.py:139), outside the FMA-flip pixels: where
    one projector's composited alpha is > 0 in one package and exactly 0
    in the other. There its taper at the feathering edge (or a grazing
    crossing) rounds differently under XLA's FMA contraction (ROADMAP
    §3), and the merge turns that 1e-8 alpha into a hit that can win the
    pixel. Such pixels may be at most 0.1% of a batch.
  * the exact oracle: tests/test_torch_stereo.py's gate for the exact
    march, fewer than 2% of the pixels flipping between transparent and
    not and max abs <= 1e-4 on the rest.
  * errors: lif_tpu's type and text.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lif_tpu
import lif_tpu_torch
from lif_tpu.models import renderer as jrenderer
from lif_tpu.parallel.sharding import make_mesh
from lif_tpu.parallel.sharding import render_fused_projectors as jfused
from lif_tpu_torch.models import renderer as trenderer
from lif_tpu_torch.ops import composite as tcomposite
from lif_tpu_torch.parallel.sharding import (
    render_fused_projectors as tfused,
)

torch.set_num_threads(1)

H, W = 64, 96
FOCAL = 0.78 * W


def _psnr(a, b):
    mse = np.mean((np.asarray(a)[..., :3] - np.asarray(b)[..., :3]) ** 2)
    return 10 * np.log10(1.0 / max(float(mse), 1e-12))


def _smooth_scene(h, w):
    """tests/test_fusion.py's smooth scene."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = (0.5 + 0.2 * np.sin(2 * np.pi * xx / w)
            * np.cos(2 * np.pi * yy / h)).astype(np.float32)
    rgb = np.stack([
        0.5 + 0.4 * np.sin(2 * np.pi * (xx + 7 * c) / (w / 3))
        * np.cos(2 * np.pi * (yy - 5 * c) / (h / 2))
        for c in range(3)
    ], axis=-1).astype(np.float32)
    return rgb, disp


def _noise_projector(rng, x, depth_bias=0.0, layers=1, h=H, w=W):
    """tests/test_fusion.py's _proj: blurred noise colour, random
    disparity biased nearer or farther, and for layers=2 a masked second
    layer (the first flipped, half the disparity)."""
    rgb = rng.random((h, w, 3), dtype=np.float32)
    k = np.ones(5, np.float32) / 5.0
    for c in range(3):
        rgb[..., c] = np.apply_along_axis(
            lambda r: np.convolve(r, k, mode="same"), 1, rgb[..., c])
    disp = np.clip(rng.uniform(0.3, 0.7, (h, w)).astype(np.float32)
                   + depth_bias, 0.01, 0.99)
    extra = None
    if layers > 1:
        extra = [dict(rgb=rgb[::-1].copy(),
                      disp=np.clip(disp * 0.5, 0.01, 0.99),
                      mask=(rng.random((h, w)) > 0.3).astype(np.float32),
                      focal_px=0.78 * w, invz_min=2.0, invz_max=0.2)]
    return dict(rgb=rgb, disp=disp, focal_px=0.78 * w, invz_min=2.0,
                invz_max=0.2, baseline=1.0, position=(x, 0.0, 0.0),
                extra_layers=extra)


def _both(kw):
    """A lif_tpu projector from projector_from_arrays' arguments and the
    port's copy on CPU tensors."""
    rgb, disp = kw.pop("rgb"), kw.pop("disp")
    jp = lif_tpu.projector_from_arrays(rgb, disp, **kw)
    return jp, lif_tpu_torch.projector_from_reference(jp, device="cpu")


def _baseline_pair():
    """tests/test_fusion.py's different-baselines pair: a red surface 1 m
    away seen with baseline 4 and a green one 2 m away with baseline 1."""
    out = []
    for c, depth, baseline in ((0, 1.0, 4.0), (1, 2.0, 1.0)):
        rgb = np.zeros((H, W, 3), np.float32)
        rgb[..., c] = 1.0
        izmin = baseline / depth
        out.append(dict(rgb=rgb, disp=np.ones((H, W), np.float32),
                        focal_px=FOCAL, invz_min=izmin,
                        invz_max=izmin * 1e-3, baseline=baseline))
    return out


def _case(name, rng):
    """(projector kwargs list, camera positions, camera skew)."""
    xs3 = [[x, 0.0, 0.0] for x in (-0.01, 0.0, 0.015)]
    if name == "two":
        return ([_noise_projector(rng, -0.02, 0.25),
                 _noise_projector(rng, 0.02, -0.25)], xs3, (0.0, 0.0))
    if name == "four":
        return ([_noise_projector(rng, x) for x in (-0.03, -0.01, 0.01, 0.03)],
                xs3, (0.0, 0.0))
    if name == "ldi":
        return ([_noise_projector(rng, x, layers=2) for x in (-0.02, 0.02)],
                xs3, (0.0, 0.0))
    if name == "ldi_and_single":
        return ([_noise_projector(rng, -0.02, layers=2),
                 _noise_projector(rng, 0.02)], xs3, (0.0, 0.0))
    if name == "skewed":
        rgb, disp = _smooth_scene(H, W)
        projs = [dict(rgb=rgb, disp=disp, focal_px=FOCAL, invz_min=2.0,
                      invz_max=0.2, baseline=1.0, position=(x, 0.0, 0.0),
                      skew=sk)
                 for x, sk in ((-0.02, (0.02, -0.01)),
                               (0.02, (-0.015, 0.01)))]
        return projs, xs3, (0.01, 0.0)
    assert name == "baselines"
    return _baseline_pair(), [[1e-4, 0.0, 0.0], [0.01, 0.0, 0.0]], (0.0, 0.0)


def _cams(positions, skew=(0.0, 0.0)):
    return ([lif_tpu.Camera.create(W, H, focal_px=FOCAL, position=p,
                                   skew=skew) for p in positions],
            [lif_tpu_torch.Camera.create(W, H, focal_px=FOCAL, position=p,
                                         skew=skew) for p in positions])


def _flip_pixels(pairs, jcams, tcams):
    """(B, H, W) pixels where some projector's composited alpha is > 0 in
    one package and 0 in the other: render_fast_batch at the fused poses
    with the fused mask mode, over a zero background in linear light."""
    flips = None
    for jp, tp in pairs:
        mode = "multiply" if jp.num_layers > 1 else "none"
        kw = dict(to_srgb=False, background=(0.0, 0.0, 0.0, 0.0),
                  mask_mode=mode)
        ja = np.asarray(lif_tpu.render_fast_batch(jp, jcams, **kw))[..., 3]
        ta = lif_tpu_torch.render_fast_batch(tp, tcams, **kw)[..., 3].numpy()
        f = (ja > 0.0) != (ta > 0.0)
        flips = f if flips is None else flips | f
    return flips


def _assert_fast_gate(got, ref, flips):
    assert got.shape == ref.shape
    assert flips.mean() <= 1e-3, f"{int(flips.sum())} flip pixels"
    err = np.abs(got - ref).max(-1)
    assert err[~flips].max() < 3e-5


@pytest.mark.parametrize("tol", [0.0, 0.05, 0.1])
def test_fusion_weights_match_lif_tpu(rng, tol):
    """composite.fusion_weights on hand-made candidates (distinct, tied at
    the front, inside and outside the band, at its edge, a lone hit, no hit,
    best = 0 with a tie, negative keys) and on 4096 random ones with
    misses, against lif_tpu's, element for element."""
    inf = np.inf
    cols = np.array([
        [1.0, 0.99, 0.5], [1.0, 1.0, 0.2], [2.0, 1.9, 1.8],
        [2.0, 2.0 * (1 - tol), 1.0], [0.7, -inf, -inf], [-inf, -inf, -inf],
        [0.0, 0.0, -inf], [0.0, -inf, 0.0], [-0.5, -0.51, -0.6],
        [3.0, 2.99, 2.98],
    ], np.float32).T  # (V=3, N)
    rand = rng.uniform(0.0, 2.0, (3, 4096)).astype(np.float32)
    rand[:, ::7] = np.float32(rand[0, ::7])  # ties
    rand[rng.random((3, 4096)) < 0.2] = -inf
    for key in (cols, rand):
        hit = np.isfinite(key)
        best = key.max(axis=0)
        ref = np.asarray(jrenderer._fusion_weights(
            jnp.asarray(key), jnp.asarray(best), jnp.asarray(hit), tol))
        got = tcomposite.fusion_weights(
            torch.from_numpy(key), torch.from_numpy(best),
            torch.from_numpy(hit), tol)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), ref)
        assert np.isfinite(ref).all()


@pytest.mark.parametrize("to_srgb", [True, False])
@pytest.mark.parametrize("name", ["two", "four", "ldi", "ldi_and_single",
                                  "skewed", "baselines"])
def test_fused_fast_batch_matches_lif_tpu(rng, name, to_srgb):
    """render_fused_fast_batch on 2 and 4 projectors, LDI projectors
    ('multiply' per projector), an LDI beside a single layer, skewed
    projectors under a skewed camera and projectors with different
    baselines, against lif_tpu's (the fast gate); the nearer (red)
    surface wins across baselines in both."""
    projs, positions, skew = _case(name, rng)
    pairs = [_both(kw) for kw in projs]
    jcams, tcams = _cams(positions, skew)
    jps, tps = zip(*pairs)
    ref = np.asarray(lif_tpu.render_fused_fast_batch(jps, jcams,
                                                     to_srgb=to_srgb))
    got = lif_tpu_torch.render_fused_fast_batch(tps, tcams, to_srgb=to_srgb)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    _assert_fast_gate(got.numpy(), ref, _flip_pixels(pairs, jcams, tcams))
    if name == "baselines":
        c = got[0, H // 2, W // 2].numpy()
        assert c[0] > 0.9 and c[1] < 0.1, c


@pytest.mark.parametrize("tol", [0.0, 0.1])
def test_fused_fast_fuse_tol_matches_lif_tpu(rng, tol):
    """config.fuse_tol 0 (the hard merge with tie averaging) and 0.1 on
    the four projectors, against lif_tpu's at the same setting."""
    projs, positions, _ = _case("four", rng)
    pairs = [_both(kw) for kw in projs]
    jcams, tcams = _cams(positions)
    jps, tps = zip(*pairs)
    ref = np.asarray(lif_tpu.render_fused_fast_batch(
        jps, jcams, config=lif_tpu.DEFAULT_CONFIG.replace(fuse_tol=tol)))
    got = lif_tpu_torch.render_fused_fast_batch(
        tps, tcams, config=lif_tpu_torch.DEFAULT_CONFIG.replace(fuse_tol=tol))
    _assert_fast_gate(got.numpy(), ref, _flip_pixels(pairs, jcams, tcams))


def test_fused_fast_single_pose_matches_lif_tpu(rng):
    """render_fused_fast (a batch of one) against lif_tpu's, the LDI pair
    at one pose; equal to the port's batch entry at that pose."""
    projs, _, _ = _case("ldi", rng)
    pairs = [_both(kw) for kw in projs]
    jcams, tcams = _cams([[0.012, 0.0, 0.0]])
    jps, tps = zip(*pairs)
    ref = np.asarray(lif_tpu.render_fused_fast(jps, jcams[0]))
    got = lif_tpu_torch.render_fused_fast(tps, tcams[0])
    assert got.shape == (H, W, 4)
    _assert_fast_gate(got.numpy()[None], ref[None],
                      _flip_pixels(pairs, jcams, tcams))
    assert torch.equal(
        got, lif_tpu_torch.render_fused_fast_batch(tps, tcams)[0])


def test_fused_fast_batch_equals_its_single_calls(rng):
    """A batch of three poses equals per-pose fusion (the per-pose snap
    grids of the batch plan are each pose's own)."""
    projs, positions, _ = _case("two", rng)
    tps = [_both(kw)[1] for kw in projs]
    _, tcams = _cams(positions)
    batched = lif_tpu_torch.render_fused_fast_batch(tps, tcams)
    for i, cam in enumerate(tcams):
        single = lif_tpu_torch.render_fused_fast(tps, cam)
        assert (batched[i] - single).abs().max().item() < 1e-5, i


def test_fused_fast_pose_chunks_equal_one_chunk(rng):
    """config.pose_chunk=2 splits five poses into chunks of 2 + 2 + 1;
    the frames equal the one-chunk call bit for bit."""
    projs, _, _ = _case("ldi_and_single", rng)
    tps = [_both(kw)[1] for kw in projs]
    _, tcams = _cams([[0.004 * i, 0.0, 0.0] for i in range(5)])
    whole = lif_tpu_torch.render_fused_fast_batch(tps, tcams)
    chunked = lif_tpu_torch.render_fused_fast_batch(
        tps, tcams, config=lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=2))
    assert trenderer._pose_chunks(5, 2) == [slice(0, 2), slice(2, 4),
                                            slice(4, 6)]
    assert torch.equal(whole, chunked)


def test_fused_fast_memory_bound_chunks_equal_one_chunk(rng, monkeypatch):
    """The fused core bounds its pose chunk by the device's free memory at
    _FUSED_BYTES_PER_LAYER_PX (on CUDA; the CPU has no bound, so the test
    hands it a free-memory reading): with free memory for two poses of
    two projectors of three layers in all, five poses render in chunks
    of 2 + 2 + 1 and equal the one-chunk call bit for bit; pose_chunk
    stays an upper bound."""
    projs, _, _ = _case("ldi_and_single", rng)
    tps = [_both(kw)[1] for kw in projs]
    _, tcams = _cams([[0.004 * i, 0.0, 0.0] for i in range(5)])
    whole = lif_tpu_torch.render_fused_fast_batch(tps, tcams)
    n_layers = sum(p.num_layers for p in tps)
    per_pose = n_layers * H * W * trenderer._FUSED_BYTES_PER_LAYER_PX

    def chunk(pose_chunk, free):
        return trenderer._fused_pose_chunk(n_layers, H, W, pose_chunk, free)

    assert chunk(48, None) == 48
    assert chunk(48, 2 * per_pose + 1) == 2
    assert chunk(1, 2 * per_pose) == 1
    assert chunk(None, per_pose - 1) == 1
    assert trenderer._free_device_bytes(torch.device("cpu")) is None
    chunks = []
    real = trenderer._pose_chunks
    monkeypatch.setattr(trenderer, "_free_device_bytes",
                        lambda device: 2 * per_pose + 1)
    monkeypatch.setattr(trenderer, "_pose_chunks",
                        lambda b, c: chunks.append(c) or real(b, c))
    bounded = lif_tpu_torch.render_fused_fast_batch(tps, tcams)
    assert chunks == [2]
    assert torch.equal(whole, bounded)


def test_fused_fast_single_projector_is_the_fast_view(rng):
    """One skewed projector 'fused' is render_fast_view's skewed lateral
    frame (tests/test_fusion.py:191's reduction, in the port): one
    candidate weighs 1, so the merge returns its composite."""
    rgb, disp = _smooth_scene(H, W)
    proj = lif_tpu_torch.projector_from_arrays(
        rgb, disp, focal_px=FOCAL, invz_min=2.0, invz_max=0.2, baseline=1.0,
        skew=(0.02, -0.015), device="cpu")
    cam = lif_tpu_torch.Camera.create(W, H, focal_px=FOCAL,
                                      position=[0.03, 0.0, 0.0],
                                      skew=(0.005, 0.01))
    fused = lif_tpu_torch.render_fused_fast([proj], cam, to_srgb=False)
    view = lif_tpu_torch.render_fast_view(proj, cam, to_srgb=False,
                                          mask_mode="none")
    assert (fused - view).abs().max().item() < 1e-6


@pytest.mark.parametrize("name,views,steps", [
    ("four", 4, 160), ("two", 2, 60), ("ldi", 2, 120),
    ("ldi_and_single", 2, 120), ("skewed", 2, 100), ("baselines", 2, 60),
])
def test_render_fused_projectors_matches_lif_tpu(rng, name, views, steps):
    """The exact fused oracle in one process against lif_tpu's shard_map
    fusion on a `views`-device virtual CPU mesh: 2 and 4 projectors, LDI
    projectors, mixed layer counts (one mask mode for all views: multiply;
    lif_tpu pads the single layer with a dead one), skew and different
    baselines (invz2 compared as is), at 60-160 steps."""
    projs, positions, skew = _case(name, rng)
    pairs = [_both(kw) for kw in projs]
    assert len(pairs) == views
    jcams, tcams = _cams(positions[-1:], skew)
    mesh = make_mesh(("view",), (views,), devices=jax.devices()[:views])
    jps, tps = zip(*pairs)
    ref = np.asarray(jfused(jps, jcams[0], mesh, num_steps=steps))
    got = tfused(tps, tcams[0], num_steps=steps)
    assert got.shape == (H, W, 4) and got.device.type == "cpu"
    got = got.numpy()
    flips = (ref[..., 3] <= 1e-6) != (got[..., 3] <= 1e-6)
    assert flips.mean() < 0.02
    assert np.abs(got - ref)[~flips].max() <= 1e-4
    if name == "baselines":
        c = tfused(tps, tcams[0], num_steps=steps, to_srgb=False)[
            H // 2, W // 2].numpy()
        assert c[0] > 0.9 and c[1] < 0.1, c


@pytest.mark.parametrize("tol", [0.0, 0.1])
def test_render_fused_projectors_options_match_lif_tpu(rng, tol):
    """fuse_tol, to_srgb=False, an explicit mask mode and a background on
    the LDI pair, against lif_tpu's at the same options."""
    projs, positions, _ = _case("ldi", rng)
    pairs = [_both(kw) for kw in projs]
    jcams, tcams = _cams(positions[:1])
    mesh = make_mesh(("view",), (2,), devices=jax.devices()[:2])
    kw = dict(num_steps=80, fuse_tol=tol, to_srgb=False, mask_mode="none",
              background=(0.2, 0.3, 0.4, 0.5))
    jps, tps = zip(*pairs)
    ref = np.asarray(jfused(jps, jcams[0], mesh, **kw))
    got = tfused(tps, tcams[0], **kw).numpy()
    flips = (ref[..., 3] <= 0.5 + 1e-6) != (got[..., 3] <= 0.5 + 1e-6)
    assert flips.mean() < 0.02
    assert np.abs(got - ref)[~flips].max() <= 1e-4


def test_fused_fast_against_the_exact_oracle(rng):
    """The port's fast fusion against the port's exact fused oracle on
    the four projectors, at tests/test_fusion.py's bar (> 30 dB), and the
    skewed pair at its bar (> 40 dB at 320 steps)."""
    sl = (slice(12, -12), slice(16, -16))
    for name, steps, bar in (("four", 160, 30.0), ("skewed", 320, 40.0)):
        projs, positions, skew = _case(name, rng)
        tps = [_both(kw)[1] for kw in projs]
        _, tcams = _cams(positions[-1:] if name == "skewed" else [[0, 0, 0]],
                         skew)
        fast = lif_tpu_torch.render_fused_fast(tps, tcams[0]).numpy()
        exact = tfused(tps, tcams[0], num_steps=steps).numpy()
        assert _psnr(fast[sl], exact[sl]) > bar, name


def test_fused_same_scene_is_well_conditioned():
    """tests/test_fusion.py:261 in the port: four projectors synthesized
    from one smooth base view at x = 0.02 i (render_fast_view and
    render_depth_fast at their own poses) fuse back to the base view's
    frame at x = 0.05 m above 45 dB."""
    rgb, disp = _smooth_scene(H, W)
    izmin, izmax = 2.0, 0.2
    base = lif_tpu_torch.projector_from_arrays(
        rgb, disp, focal_px=FOCAL, invz_min=izmin, invz_max=izmax,
        baseline=1.0, device="cpu")
    projs = []
    for i in range(4):
        pos = [0.02 * i, 0.0, 0.0]
        cam_i = lif_tpu_torch.Camera.create(W, H, focal_px=FOCAL,
                                            position=pos)
        rgb_i = lif_tpu_torch.render_fast_view(
            base, cam_i, to_srgb=False, mask_mode="none")[..., :3].numpy()
        invz_i = lif_tpu_torch.render_depth_fast(base, cam_i).numpy()
        d_i = np.clip((invz_i - izmax) / (izmin - izmax), 0, 1)
        projs.append(lif_tpu_torch.projector_from_arrays(
            rgb_i, d_i.astype(np.float32), focal_px=FOCAL, invz_min=izmin,
            invz_max=izmax, baseline=1.0, position=pos, device="cpu"))
    cam = lif_tpu_torch.Camera.create(W, H, focal_px=FOCAL,
                                      position=[0.05, 0.0, 0.0])
    fused = lif_tpu_torch.render_fused_fast(projs, cam, to_srgb=False)
    gold = lif_tpu_torch.render_fast_view(base, cam, to_srgb=False,
                                          mask_mode="none")
    sl = (slice(12, -12), slice(16, -16))
    assert _psnr(fused[sl].numpy(), gold[sl].numpy()) > 45.0


def _errors(rng):
    """(what, lif_tpu call, port call) pairs that must raise alike."""
    projs, _, _ = _case("two", rng)
    pairs = [_both(kw) for kw in projs]
    jps, tps = zip(*pairs)
    jc, tc = _cams([[0.0, 0.0, 0.0], [0.01, 0.0, 0.0]])
    out = {}
    out["no camera"] = (lambda: lif_tpu.render_fused_fast_batch(jps, []),
                        lambda: lif_tpu_torch.render_fused_fast_batch(tps, []))
    for what, kw in (("width", dict(w=W + 8)), ("focal", dict(f=FOCAL + 1)),
                     ("skew", dict(skew=(0.01, 0.0)))):
        w, f = kw.get("w", W), kw.get("f", FOCAL)
        jbad = lif_tpu.Camera.create(w, H, focal_px=f, skew=kw.get(
            "skew", (0.0, 0.0)))
        tbad = lif_tpu_torch.Camera.create(w, H, focal_px=f, skew=kw.get(
            "skew", (0.0, 0.0)))
        out[f"camera {what}"] = (
            lambda jbad=jbad: lif_tpu.render_fused_fast_batch(
                jps, [jc[0], jbad]),
            lambda tbad=tbad: lif_tpu_torch.render_fused_fast_batch(
                tps, [tc[0], tbad]))
    for what, pos, rot in (
            ("y pose", [0.0, 0.01, 0.0], None),
            ("z pose", [0.0, 0.0, 0.02], None),
            ("yaw", [0.0, 0.0, 0.0],
             lif_tpu.orbit_pose([0, 0, -1], 1.0, 0.05)[1])):
        jcam = lif_tpu.Camera.create(W, H, focal_px=FOCAL, position=pos,
                                     rotation=rot)
        tcam = lif_tpu_torch.Camera.create(W, H, focal_px=FOCAL,
                                           position=pos, rotation=rot)
        out[what] = (lambda jcam=jcam: lif_tpu.render_fused_fast(jps, jcam),
                     lambda tcam=tcam: lif_tpu_torch.render_fused_fast(
                         tps, tcam))
    for what, cam_kw in (("dims", dict(w=W - 8)), ("focal", dict(f=FOCAL * 1.1)),
                         ("odd width", dict(w=W - 1))):
        w, f = cam_kw.get("w", W), cam_kw.get("f", FOCAL)
        jcam = lif_tpu.Camera.create(w, H, focal_px=f)
        tcam = lif_tpu_torch.Camera.create(w, H, focal_px=f)
        out[f"layer {what}"] = (
            lambda jcam=jcam: lif_tpu.render_fused_fast(jps, jcam),
            lambda tcam=tcam: lif_tpu_torch.render_fused_fast(tps, tcam))
    small = _both(_noise_projector(rng, 0.0, h=32, w=48))
    out["oracle dims"] = (
        lambda: jfused([jps[0], small[0]], jc[0], make_mesh(
            ("view",), (2,), devices=jax.devices()[:2])),
        lambda: tfused([tps[0], small[1]], tc[0]))
    return out


_ERRORS = ("no camera", "camera width", "camera focal", "camera skew",
           "y pose", "z pose", "yaw", "layer dims", "layer focal",
           "layer odd width", "oracle dims")


@pytest.mark.parametrize("what", _ERRORS)
def test_errors_match_lif_tpu(rng, what):
    """Empty and mismatched camera batches, non-lateral poses (y, z,
    yaw), layers the march cannot take (dims, focal, a width not
    divisible by 8) and oracle projectors of different dims raise
    lif_tpu's ValueError with its text."""
    jcall, tcall = _errors(rng)[what]
    with pytest.raises(ValueError) as jerr:
        jcall()
    with pytest.raises(ValueError) as terr:
        tcall()
    assert str(terr.value) == str(jerr.value)
