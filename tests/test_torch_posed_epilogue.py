"""The target and scaled epilogue's plain route, on the CPU.

A call whose every layer is routed 'march', 'target' or 'scaled' finishes
each layer of each pose chunk straight into the call's frames
(models/renderer.py::_fast_batch_core's in-place route): the orbit and
zoom layers through ops/cuda/posed_epilogue.py::posed_epilogue, on the
card its kernel and on the CPU its plain version, the PyTorch chain it
replaces. Here the CPU's default route is held bit for bit to the chain
that the route replaced (forced by turning the route off): the tier's
packed fetch and finish over a zero background, the front-to-back over of
the LDI layers, finish_over_background, the concatenation of the pose
chunks and the width-pad slice. The raw callers (stereo) and the
'rotated' and 'sweep' tiers keep the chain. The kernel is held to the
same chain on the card (tests/test_torch_cuda.py).
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lif_tpu_torch
from lif_tpu_torch.models import renderer
from lif_tpu_torch.ops import composite
from lif_tpu_torch.ops import sweep_march as tsm
from lif_tpu_torch.ops import sweep_target as tst
from lif_tpu_torch.ops.cuda import posed_epilogue as tpe
from lif_tpu_torch.ops.cuda import sweep_march as tcuda
from lif_tpu_torch.ops.sampling import pack_rgbm
from lif_tpu_torch.utils import profiling

BACKGROUND = (0.1, 0.2, 0.3, 0.7)
H = 40
# planes of the target and scaled ladders: short walks for the CPU's plain
# marches (the epilogue is the same at any K)
PLANES = 24
TIER = {"orbit": "target", "zoom": "scaled"}


def _roty(deg):
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def _rotx(deg):
    t = np.deg2rad(deg)
    c, s = np.cos(t), np.sin(t)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def _scene(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = 0.5 + 0.3 * np.sin(xx / 17) * np.cos(yy / 13)
    disp[h // 3 : h // 2, w // 4 : w // 2] = 0.95
    disp = np.clip(disp + 0.05 * rng.random((h, w)), 0.0, 1.0)
    rgb = rng.random((h, w, 3), dtype=np.float32)
    mask = (rng.random((h, w)) > 0.2).astype(np.float32)
    return rgb, disp.astype(np.float32), mask


def _projector(layers, w, back_focal=0.78):
    """One layer, or two: the back one outpainted by even margins (8 rows,
    16 columns), with focal back_focal * w; every layer masked."""
    rgb0, disp0, mask0 = _scene(w + 1, H, w)
    extra = []
    if layers > 1:
        rgb, disp, mask = _scene(w + 2, H + 8, w + 16)
        extra.append(dict(rgb=rgb, disp=disp, mask=mask,
                          focal_px=back_focal * w, invz_min=0.5,
                          invz_max=0.1))
    return lif_tpu_torch.projector_from_arrays(
        rgb0, disp0, mask0 if layers > 1 else None, focal_px=0.78 * w,
        invz_min=2.0, invz_max=0.6, baseline=1.0, device="cpu",
        extra_layers=extra)


def _poses(kind, n):
    """n poses of a yaw orbit (the target tier), a push-in (the scaled
    tier), a lateral slide or a tilted orbit (the rotated tier)."""
    if kind == "orbit":
        return [(_roty(-4.0 + 8.0 * i / n), [0.02 * i / n - 0.01, 0.0, 0.0])
                for i in range(n)]
    if kind == "zoom":
        return [(np.eye(3), [0.004, 0.002, 0.03 + 0.02 * i / n])
                for i in range(n)]
    if kind == "lateral":
        return [(np.eye(3), [0.01 + 0.007 * i, 0.0, 0.0]) for i in range(n)]
    return [(_rotx(3.0) @ _roty(4.0 - i), [0.01 * i, 0.01, 0.0])
            for i in range(n)]


def _cams(w, poses, focal=0.78):
    return [lif_tpu_torch.Camera.create(w, H, focal_px=focal * w,
                                        position=c, rotation=r)
            for r, c in poses]


def _spied(monkeypatch):
    """Record (tier, first, last) of every epilogue the route finishes."""
    finished = []
    plain_posed = tpe.posed_epilogue_plain
    plain_lateral = tcuda.lateral_epilogue_plain

    def posed(tier, *args, **kwargs):
        finished.append((tier, kwargs["first"], kwargs["last"]))
        return plain_posed(tier, *args, **kwargs)

    def lateral(*args, **kwargs):
        finished.append(("march", kwargs["first"], kwargs["last"]))
        return plain_lateral(*args, **kwargs)

    monkeypatch.setattr(tpe, "posed_epilogue_plain", posed)
    monkeypatch.setattr(tcuda, "lateral_epilogue_plain", lateral)
    return finished


# (layers, back layer's and camera's focal, width, poses, pose chunk,
#  mask_mode, to_srgb, background, tiers)
CASES = {
    "orbit": (1, 0.78, 128, "orbit", 3, 2, None, True, BACKGROUND,
              ("target",)),
    "orbit-multiply-linear": (1, 0.78, 128, "orbit", 2, 1, "multiply", False,
                              BACKGROUND, ("target",)),
    "orbit-ldi-hard": (2, 0.78, 128, "orbit", 2, 1, "hard", True, BACKGROUND,
                       ("target", "target")),
    "zoom": (1, 0.78, 64, "zoom", 5, 2, None, True, BACKGROUND,
             ("scaled",)),
    "zoom-ldi-none": (2, 0.78, 64, "zoom", 3, 2, "none", True, BACKGROUND,
                      ("scaled", "scaled")),
    "zoom-ldi-hard-linear": (2, 0.78, 64, "zoom", 3, 2, "hard", False,
                             BACKGROUND, ("scaled", "scaled")),
    "zoom-tensor-background": (1, 0.78, 64, "zoom", 3, 2, None, True,
                               torch.tensor(BACKGROUND), ("scaled",)),
    # the front layer's focal is not the camera's: it takes the scaled
    # tier in front of the back layer's march, both on the width-padded
    # band of a 60-column camera
    "scaled-over-padded-march": (2, 0.9, 60, "lateral", 3, 2, "multiply",
                                 True, BACKGROUND, ("scaled", "march")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_in_place_route_plain_equals_the_torch_chain(case, monkeypatch):
    """render_fast_batch on the CPU's default route, the in-place route's
    plain versions, equals the same call through the chain bit for bit;
    the route finishes each layer of each pose chunk once, in order, and
    counts epilogue.<tier>.fused once for each target or scaled one."""
    (layers, focal, w, kind, n, chunk, mask_mode, to_srgb, bg,
     tiers) = CASES[case]
    proj = _projector(layers, w, focal)
    cams = _cams(w, _poses(kind, n), focal)
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=chunk)
    kw = dict(config=cfg, background=bg, to_srgb=to_srgb,
              mask_mode=mask_mode, num_planes=PLANES)
    with monkeypatch.context() as m:
        m.setattr(renderer, "_fuses_epilogue", lambda modes: False)
        ref, got_tiers = lif_tpu_torch.render_fast_batch(
            proj, cams, return_tiers=True, **kw)
    assert got_tiers == tiers

    finished = _spied(monkeypatch)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        got = lif_tpu_torch.render_fast_batch(proj, cams, **kw)
    counters = profiling.snapshot()["counters"]
    n_chunks = len(renderer._pose_chunks(n, chunk))
    assert finished == [(t, i == 0, i == layers - 1)
                        for i, t in enumerate(tiers)] * n_chunks
    for tier in ("target", "scaled"):
        assert counters.get(f"epilogue.{tier}.fused", 0) == (
            n_chunks * tiers.count(tier))
    assert got.shape == ref.shape == (n, H, w, 4)
    assert got.is_contiguous()
    assert torch.equal(got, ref)


@pytest.mark.parametrize("to_srgb", [True, False])
def test_march_in_front_of_target_equals_the_chain(to_srgb):
    """A 'march' layer finished in front of a 'target' layer (the lateral
    and posed epilogues' plain versions one after the other, first and
    last) equals the chain: each layer over a zero background, the over of
    _fast_batch_core and finish_over_background, bit for bit."""
    b, h, w = 3, H, 64
    g = torch.Generator().manual_seed(5)
    rgb, disp, mask = (torch.from_numpy(t) for t in _scene(9, h, w))
    found_m = (torch.rand((b, h, w), generator=g) > 0.3).float()
    invz_m = 0.6 + 1.4 * torch.rand((b, h, w), generator=g)
    rgba_m = torch.rand((b, h, w, 4), generator=g)
    c1 = torch.tensor([[0.01 * i, 0.0, 0.0] for i in range(b)])
    plan_m = tsm.translation_plan(w, h, w, h, 4.0, 0.0)
    f1 = 0.78 * w
    found_t = (torch.rand((b, h, w), generator=g) > 0.2).float()
    vstar = 0.5 + 1.6 * torch.rand((b, h, w), generator=g)
    poses = torch.from_numpy(np.stack([
        tst.target_pose_scalars(_roty(2.0 * i), [0.01 * i, 0.0, 0.0], f1, f1,
                                w, h, w, h) for i in range(b)]))
    packed = pack_rgbm(rgb, mask)
    plan_t = types.SimpleNamespace(out_w=w, out_h=h, src_w=w, src_h=h)
    kw = dict(feathering=0.1, mask_mode="multiply")
    zero = np.zeros(4, np.float32)

    front = tsm._finalize(plan_m, found_m, invz_m, rgba_m, c1, f1, zero,
                          kw["feathering"], kw["mask_mode"], False)
    back = tst.fetch_finish(found_t, vstar, poses, packed, 2.0, 0.6, w, h,
                            zero, kw["feathering"], kw["mask_mode"], False,
                            False)
    rgb_acc = front[..., :3] + (1.0 - front[..., 3][..., None]) * back[..., :3]
    a_acc = front[..., 3] + (1.0 - front[..., 3]) * back[..., 3]
    ref = composite.finish_over_background(rgb_acc, a_acc, BACKGROUND,
                                           to_srgb)

    out = torch.full((b, h, w, 4), float("nan"))
    tcuda.lateral_epilogue_plain(found_m, invz_m, rgba_m, c1, plan_m, f1,
                                 BACKGROUND, out, to_srgb=to_srgb,
                                 first=True, last=False, **kw)
    tpe.posed_epilogue("target", found_t, vstar, poses, (plan_t, 2.0, 0.6),
                       packed, BACKGROUND, out, to_srgb=to_srgb, first=False,
                       last=True, **kw)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("kind,method", [("tilted", "auto"),
                                         ("zoom", "sweep")])
def test_rotated_and_sweep_keep_the_chain(kind, method, monkeypatch):
    """A call on the 'rotated' or 'sweep' tier finishes no layer in place:
    no epilogue runs, and the chain composites it."""
    proj = _projector(1, 64)
    finished = _spied(monkeypatch)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _, tiers = lif_tpu_torch.render_fast_batch(
            proj, _cams(64, _poses(kind, 2)), method=method, num_planes=16,
            return_tiers=True)
    assert tiers == ("rotated",) if kind == "tilted" else ("sweep",)
    assert finished == []
    assert "lif.composite" in profiling.snapshot()["spans"]


def test_packed_texture_is_cached_with_the_texture():
    """The packed texture is pack_rgbm of the layer's textures, built once
    and kept in its texture-cache entry across calls."""
    proj = _projector(2, 128)
    lif_tpu_torch.render_fast_batch(proj, _cams(128, _poses("orbit", 2)),
                                    num_planes=PLANES)
    lays = renderer._prepared_textures(proj)
    packs = [lay["packed"] for lay in lays]
    for lay, pack in zip(lays, packs):
        assert torch.equal(pack, pack_rgbm(lay["rgb"], lay["mask"]))
    lif_tpu_torch.render_fast_batch(proj, _cams(128, _poses("zoom", 2)),
                                    num_planes=PLANES)
    assert all(lay["packed"] is pack for lay, pack in zip(lays, packs))


@pytest.mark.parametrize("kind", ["orbit", "zoom"])
def test_stereo_outputs_do_not_change(kind, monkeypatch):
    """render_stereo_fast_batch, a raw caller, keeps the chain on the
    target and scaled tiers: no epilogue runs, and its frames (of LDI
    eyes, which march the eroded mask) are the same bit for bit whether or
    not a mono call has packed the texture's own mask first."""
    left = _projector(2, 128)
    right = _projector(2, 128)
    cams = _cams(128, _poses(kind, 2))
    renderer._TEX_CACHE.clear()
    fresh, tiers = lif_tpu_torch.render_stereo_fast_batch(
        left, right, cams, num_planes=PLANES, return_tiers=True)
    assert tiers == ((TIER[kind],) * 2,) * 2
    for proj in (left, right):
        lif_tpu_torch.render_fast_batch(proj, cams, num_planes=PLANES)
        assert "packed" in renderer._prepared_textures(proj)[0]
    finished = _spied(monkeypatch)
    got = lif_tpu_torch.render_stereo_fast_batch(left, right, cams,
                                                 num_planes=PLANES)
    assert finished == []
    assert torch.equal(got, fresh)
