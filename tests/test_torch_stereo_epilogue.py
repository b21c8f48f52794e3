"""The stereo epilogue's plain route and its route decision, on the CPU.

render_stereo_fast_batch finishes each layer of a pose chunk that both
eyes march on the lateral tier in one stereo epilogue
(models/renderer.py::_stereo_core, ops/cuda/stereo_epilogue.py): on the
card one kernel launch, on the CPU its plain version, the PyTorch chain
the kernel replaces. Here the CPU route is held bit for bit to a frozen
copy of that chain as the stereo core ran it before the kernel (each eye
through _layer_tier_batch's raw march, the view's concatenation, the
stretch-mark confidence, occlusion_blend, composite.over, the finish and
the chunks' concatenation), over one and three layers, every confidence
step, blend weights of 0, 1 and between, and chunks that do not divide
the batch; the counter to the plain version's calls; a call whose layers
mix the two routes; and a batch with an eye off the lateral tier to the
chain, with no fused count. The kernel is
held to the same chain on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import lif_tpu_torch
from lif_tpu_torch.core.transforms import (inv3, mat_from_focal, mm,
                                           shader_rotation)
from lif_tpu_torch.models import renderer
from lif_tpu_torch.ops import composite
from lif_tpu_torch.ops import stereo as tstereo
from lif_tpu_torch.ops.cuda import stereo_epilogue as tse
from lif_tpu_torch.ops.sampling import read_disp
from lif_tpu_torch.utils import profiling

BACKGROUND = (0.1, 0.2, 0.3, 0.7)
EYE = 0.1  # m: the views at -+EYE


def _scene(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = 0.5 + 0.3 * np.sin(xx / 7) * np.cos(yy / 5)
    disp[h // 3 : h // 2, w // 4 : w // 2] = 0.95
    disp = np.clip(disp + 0.2 * rng.random((h, w)), 0.0, 1.0)
    rgb = rng.random((h, w, 3), dtype=np.float32)
    mask = (rng.random((h, w)) > 0.2).astype(np.float32)
    return rgb, disp.astype(np.float32), mask


EVEN = ((16, 32), (8, 16))  # the back layers' outpaint (rows, columns)


def _view(seed, x, layers, h, w, skew=(0.0, 0.0), margins=EVEN):
    """One view at (x, 0, 0): one layer, or a masked 3-layer LDI whose
    back two layers are outpainted by `margins` (rows, columns): by
    default even ones, which the lateral march takes."""
    focal = 0.78 * w
    rgb0, disp0, mask0 = _scene(seed, h, w)
    extra = []
    for i, (dh, dw) in enumerate(margins[: layers - 1]):
        rgb, disp, mask = _scene(seed + i + 1, h + dh, w + dw)
        extra.append(dict(rgb=rgb, disp=disp, mask=mask, focal_px=focal,
                          invz_min=0.5 - 0.1 * i, invz_max=0.1))
    return lif_tpu_torch.projector_from_arrays(
        rgb0, disp0, mask0 if layers > 1 else None, focal_px=focal,
        invz_min=2.0, invz_max=0.6, baseline=1.0, position=(x, 0.0, 0.0),
        skew=skew, device="cpu", extra_layers=extra)


def _pair(layers, h, w, skew=(0.0, 0.0), margins=EVEN):
    return (_view(10, -EYE, layers, h, w, skew, margins),
            _view(20, EYE, layers, h, w, skew, margins))


def _cams(xs, h, w, skew=(0.0, 0.0), rot=None):
    return [lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                        position=[x, 0.0, 0.0], rotation=rot,
                                        skew=skew) for x in xs]


def _frozen_conf(lay, c1_b, rot_b, hit, invz, f2, out_w, out_h):
    """The renderer's _stretch_conf as it ran before the kernel (a frozen
    copy)."""
    f32 = np.float32
    disp = lay["disp"]
    hs, ws = disp.shape
    dev = disp.device
    izmin, izmax = f32(lay["izmin_host"]), f32(lay["izmax_host"])
    f1, f2 = f32(lay["focal_host"]), f32(f2)
    ds = 4 if (out_h % 4 == 0 and out_w % 4 == 0) else (
        2 if (out_h % 2 == 0 and out_w % 2 == 0) else 1
    )
    jx = (torch.arange(out_w // ds, dtype=torch.float32, device=dev) * ds
          + 0.5) / out_w - 0.5
    iy = (torch.arange(out_h // ds, dtype=torch.float32, device=dev) * ds
          + 0.5) / out_h - 0.5
    s2x, s2y = jx[None, None, :], iy[None, :, None]
    fskr1 = mm(mat_from_focal(f1 / f32(ws), f1 / f32(hs)),
               shader_rotation(np.asarray(rot_b, np.float32)))
    p = mm(fskr1, inv3(mat_from_focal(f2 / f32(out_w), f2 / f32(out_h))))
    c_vec = (fskr1 @ -torch.as_tensor(np.asarray(c1_b, np.float32))[..., None])
    p, c_vec = p.to(dev)[..., None, None], c_vec[..., 0].to(dev)[..., None, None]
    den = p[:, 2, 0] * s2x + p[:, 2, 1] * s2y + p[:, 2, 2]
    qx = (p[:, 0, 0] * s2x + p[:, 0, 1] * s2y + p[:, 0, 2]) / den
    qy = (p[:, 1, 0] * s2x + p[:, 1, 1] * s2y + p[:, 1, 2]) / den
    dsx = c_vec[:, 0] - c_vec[:, 2] * qx
    dsy = c_vec[:, 1] - c_vec[:, 2] * qy
    dxp = float(f32(lay["doff"][0]) / f32(ws))
    dyp = float(f32(lay["doff"][1]) / f32(hs))
    dv = (izmin - izmax) / f32(40.0)

    def disp_at(v):
        return read_disp(disp, qx + v * dsx + 0.5 + dxp,
                         qy + v * dsy + 0.5 + dyp, float(izmin),
                         float(izmax), ws, hs)

    invz_c = invz[:, ::ds, ::ds]
    kill = (torch.abs(disp_at(invz_c) - disp_at(invz_c + float(dv)))
            > float(f32(2.8) * dv))
    kill = kill.repeat_interleave(ds, 1).repeat_interleave(ds, 2)
    return torch.where(kill & (hit > 0.5), 0.0, 1.0)


def _chain(left, right, cams, cfg, background, to_srgb):
    """render_stereo_fast_batch's body as it ran before the stereo
    epilogue, operator for operator (a frozen copy of its chain)."""
    num_layers = min(left.num_layers, right.num_layers)
    mask_mode = "hard" if num_layers > 1 else "none"
    eyes = [renderer._stereo_eye(p, cams, num_layers, mask_mode, cfg, None)
            for p in (left, right)]
    w_r = tstereo.view_weight(np.zeros(3), eyes[0].pos_b,
                              eyes[1].pos_b)[:, None, None, None]
    cam0 = cams[0]
    f2, out_w, out_h = float(cam0.focal_px), cam0.width, cam0.height
    outs = []
    for sl in renderer._pose_chunks(len(w_r), cfg.pose_chunk):
        acc = None
        for i in range(num_layers):
            views, confs = [], []
            for eye in eyes:
                lay = renderer._chunk_layer(eye.layers[i], sl)
                rgba, alpha, hit, invz = renderer._layer_tier_batch(
                    lay, eye.modes[i], eye.setups[i], eye.plans[i],
                    eye.nums[i], eye.crops[i], eye.pos_b[sl], eye.rot_b[sl],
                    f2, out_w, out_h, refine=cfg.march_refine,
                    rot_refine=cfg.rotated_refine,
                    t_refine=cfg.target_refine, feathering=cfg.feathering,
                    mask_mode=mask_mode, raw=True)
                views.append(torch.cat([rgba[..., :3], alpha[..., None]],
                                       dim=-1))
                confs.append(_frozen_conf(lay, eye.pos_b[sl], eye.rot_b[sl],
                                          hit, invz, f2, out_w, out_h))
            blend = tstereo.occlusion_blend(*views, *confs, w_r[sl])
            acc = composite.over(acc, blend)
        outs.append(composite.finish_over_background(*acc, background,
                                                     to_srgb))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


# (layers, h, w, camera xs, pose_chunk, to_srgb, skewed): the confidence
# step 4 at 32x64, 2 at 30x64, 1 at 33x64; the xs put the camera left of
# the left view (w_r 0), between the views and right of the right one
# (w_r 1)
XS = [-0.12, -0.04, 0.015, 0.06, 0.13]
CASES = {
    "one-layer-ds4": (1, 32, 64, XS, 48, True, False),
    "one-layer-ds2-chunks": (1, 30, 64, XS, 2, True, False),
    "one-layer-ds1-linear": (1, 33, 64, XS[:3], 2, False, False),
    "ldi-ds4-chunks": (3, 32, 64, XS, 2, True, False),
    "ldi-ds2": (3, 30, 64, XS[1:4], 48, True, False),
    "ldi-ds1-chunks": (3, 33, 64, XS, 3, False, False),
    "ldi-skewed": (3, 32, 64, XS[:4], 3, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_route_equals_the_chain(case):
    """render_stereo_fast_batch on the CPU (both eyes' marches, then the
    stereo epilogue's plain version into the call's frames) equals the
    frozen chain bit for bit."""
    layers, h, w, xs, chunk, to_srgb, skewed = CASES[case]
    skew = (0.021, -0.0137) if skewed else (0.0, 0.0)
    left, right = _pair(layers, h, w, skew)
    cams = _cams(xs, h, w, (0.004, 0.0061) if skewed else (0.0, 0.0))
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=chunk)
    got, tiers = lif_tpu_torch.render_stereo_fast_batch(
        left, right, cams, config=cfg, background=BACKGROUND,
        to_srgb=to_srgb, return_tiers=True)
    assert tiers == (("march",) * layers,) * 2
    ref = _chain(left, right, cams, cfg, BACKGROUND, to_srgb)
    assert got.shape == ref.shape == (len(xs), h, w, 4)
    assert 0.0 < float(got[..., 3].mean()) <= 1.0
    assert torch.equal(got, ref)


def test_weights_span_zero_to_one():
    """The cases' cameras give blend weights of 0 (left of the left
    view), 1 (right of the right view) and strictly between."""
    left, right = _pair(1, 32, 64)
    poses = [renderer._read_poses(p, _cams(XS, 32, 64)).pos_b
             for p in (left, right)]
    w_r = tstereo.view_weight(np.zeros(3), *poses).numpy()
    assert w_r[0] == 0.0 and w_r[-1] == 1.0
    assert ((w_r[1:-1] > 0.0) & (w_r[1:-1] < 1.0)).all()


@pytest.mark.parametrize("layers,poses,chunk", [(1, 3, 48), (3, 5, 2)])
def test_fused_counter_counts_each_plain_call(layers, poses, chunk):
    """epilogue.stereo.fused counts once a layer of a pose chunk, as
    stereo.blend does, each a call of the plain version on the CPU, with
    the plain version's spans (the confidence and the composite) inside
    the blend's."""
    left, right = _pair(layers, 32, 64)
    cams = _cams(XS[:poses], 32, 64)
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=chunk)
    calls = []
    real = tse.stereo_epilogue_plain

    def spy(*args, **kwargs):
        calls.append(kwargs["first"])
        return real(*args, **kwargs)

    chunks = len(renderer._pose_chunks(poses, chunk))
    tse.stereo_epilogue_plain = spy
    try:
        profiling.reset()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            lif_tpu_torch.render_stereo_fast_batch(left, right, cams,
                                                   config=cfg)
    finally:
        tse.stereo_epilogue_plain = real
    snap = profiling.snapshot()
    assert len(calls) == chunks * layers
    assert calls == [True, *[False] * (layers - 1)] * chunks
    assert snap["counters"]["epilogue.stereo.fused"] == chunks * layers
    assert snap["counters"]["stereo.blend"] == chunks * layers
    assert {"lif.stereo.blend", "lif.stereo.conf",
            "lif.composite"} <= set(snap["spans"])
    parents = {r["name"]: profiling.records()[r["parent"]]["name"]
               for r in profiling.records() if r["parent"] is not None}
    assert parents["lif.stereo.conf"] == "lif.stereo.blend"


def test_off_lateral_eye_keeps_the_chain():
    """A yawed batch routes both eyes to the target tier: every layer
    keeps the chain (no fused count, no call of the plain version), and
    the frames equal the frozen chain bit for bit."""
    h, w = 32, 64
    left, right = _pair(1, h, w)
    rot = lif_tpu_torch.orbit_pose([0, 0, -1], 1.0, 0.05)[1]
    cams = [lif_tpu_torch.Camera.create(w, h, focal_px=0.78 * w,
                                        position=[x, 0.0, 0.0], rotation=rot)
            for x in (0.02, 0.04)]
    cfg = lif_tpu_torch.DEFAULT_CONFIG
    calls = []
    real = tse.stereo_epilogue_plain
    tse.stereo_epilogue_plain = lambda *a, **k: calls.append(1)
    try:
        profiling.reset()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got, tiers = lif_tpu_torch.render_stereo_fast_batch(
                left, right, cams, config=cfg, background=BACKGROUND,
                return_tiers=True)
    finally:
        tse.stereo_epilogue_plain = real
    assert all(t != "march" for eye in tiers for t in eye)
    assert not calls
    counters = profiling.snapshot()["counters"]
    assert "epilogue.stereo.fused" not in counters
    assert counters["stereo.blend"] == 1
    ref = _chain(left, right, cams, cfg, BACKGROUND, cfg.to_srgb)
    assert torch.equal(got, ref)


# an odd outpaint margin takes a layer off the lateral march
# (_march_eligible): the middle layer (chain between two kernel layers) or
# the back one (a chain layer behind the kernel's)
MIXED = {"middle-off": ((17, 33), (8, 16)), "back-off": ((16, 32), (9, 17))}


@pytest.mark.parametrize("case", list(MIXED))
def test_mixed_call_routes_each_layer(case):
    """A lateral LDI call whose layers mix the two routes: each layer both
    eyes march finishes in the stereo epilogue's plain version, the layer
    off the march keeps the chain, both writing the same frames; the
    frames equal the frozen chain bit for bit, and epilogue.stereo.fused
    counts the march layers of each chunk, stereo.blend every layer."""
    h, w, chunk = 32, 64, 2
    left, right = _pair(3, h, w, margins=MIXED[case])
    cams = _cams(XS, h, w)
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=chunk)
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        got, tiers = lif_tpu_torch.render_stereo_fast_batch(
            left, right, cams, config=cfg, background=BACKGROUND,
            return_tiers=True)
    off = 1 if case == "middle-off" else 2
    assert tiers[0] == tiers[1]
    assert [t == "march" for t in tiers[0]] == [i != off for i in range(3)]
    chunks = len(renderer._pose_chunks(len(XS), chunk))
    counters = profiling.snapshot()["counters"]
    assert counters["epilogue.stereo.fused"] == 2 * chunks
    assert counters["stereo.blend"] == 3 * chunks
    ref = _chain(left, right, cams, cfg, BACKGROUND, cfg.to_srgb)
    assert 0.0 < float(got[..., 3].mean()) <= 1.0
    assert torch.equal(got, ref)


def test_mixed_layers_route_each_layer():
    """_stereo_fuses decides layer by layer: a layer both eyes march
    fuses, one that either eye renders on another tier does not."""
    eye = renderer._Eye(None, None, [None] * 3, ["march", "march", "target"],
                        [], [], [], [])
    other = eye._replace(modes=["march", "scaled", "target"])
    assert [renderer._stereo_fuses([eye, other], i)
            for i in range(3)] == [True, False, False]


def test_wrapper_takes_the_plain_route_on_cpu():
    """stereo_epilogue sends CPU tensors to its plain version and leaves
    its launch count alone."""
    before = tse.stereo_epilogue.launches
    left, right = _pair(1, 32, 64)
    lif_tpu_torch.render_stereo_fast_batch(left, right, _cams(XS[:2], 32, 64))
    assert tse.stereo_epilogue.launches == before


def test_conf_step_follows_the_output_dims():
    assert [tse.conf_step(w, h) for w, h in
            ((64, 32), (64, 30), (64, 33), (1280, 800))] == [4, 2, 1, 4]
