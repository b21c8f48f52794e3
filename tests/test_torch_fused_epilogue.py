"""The fused epilogue's plain route and its route decision, on the CPU.

render_fused_fast_batch marches every layer of every projector of a pose
chunk and finishes the chunk in one fused epilogue
(models/renderer.py::_fused_fast_core, ops/cuda/fused_epilogue.py): on
the card one kernel launch, on the CPU its plain version, the PyTorch
chain the kernel replaces. Here the CPU route is held bit for bit to a
frozen copy of that chain as the fused core ran it before the kernel
(each layer through _layer_tier_batch's raw march, the over and front
depth per projector, the stack, composite.fuse_views and
finish_over_background), the kernel's entry table to its layout for any
number of projectors and layers, and the counter and span to the plain
version's calls. The kernel is held to the same chain on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import lif_tpu_torch
from lif_tpu_torch.models import renderer
from lif_tpu_torch.ops import composite
from lif_tpu_torch.ops.cuda import fused_epilogue as tfe
from lif_tpu_torch.utils import profiling

H, W = 32, 64
FOCAL = 0.78 * W
BACKGROUND = (0.1, 0.2, 0.3, 0.7)


def _scene(seed, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    disp = 0.5 + 0.3 * np.sin(xx / 17) * np.cos(yy / 13)
    disp[h // 3 : h // 2, w // 4 : w // 2] = 0.95
    disp = np.clip(disp + 0.05 * rng.random((h, w)), 0.0, 1.0)
    rgb = rng.random((h, w, 3), dtype=np.float32)
    mask = (rng.random((h, w)) > 0.2).astype(np.float32)
    return rgb, disp.astype(np.float32), mask


def _projectors(n, layers, skew=(0.0, 0.0)):
    """n projectors 1 cm apart along x, each one layer or a masked
    2-layer LDI of the camera's dims."""
    projs = []
    for i in range(n):
        rgb0, disp0, mask0 = _scene(10 + i, H, W)
        extra = []
        if layers > 1:
            rgb1, disp1, mask1 = _scene(50 + i, H, W)
            extra.append(dict(rgb=rgb1, disp=disp1, mask=mask1,
                              focal_px=FOCAL, invz_min=0.5, invz_max=0.1))
        projs.append(lif_tpu_torch.projector_from_arrays(
            rgb0, disp0, mask0 if layers > 1 else None, focal_px=FOCAL,
            invz_min=2.0, invz_max=0.6, baseline=1.0,
            position=(0.01 * i - 0.015, 0.0, 0.0), skew=skew, device="cpu",
            extra_layers=extra))
    return projs


def _cams(n, skew=(0.0, 0.0)):
    return [lif_tpu_torch.Camera.create(
        W, H, focal_px=FOCAL, position=[0.004 * i - 0.006, 0.0, 0.0],
        skew=skew) for i in range(n)]


def _chain(projs, cams, cfg, background, to_srgb):
    """The fused core as it ran before the fused epilogue, operator for
    operator (a frozen copy of its body)."""
    views = [renderer._fused_view(p, cams, cfg, None, None) for p in projs]
    out = torch.empty((len(cams), H, W, 4), dtype=torch.float32)
    for sl in renderer._pose_chunks(len(cams), cfg.pose_chunk):
        view_rgb, view_a, view_front = [], [], []
        for view in views:
            acc_rgb = acc_a = front = None
            for lay, plan, k_l in zip(view.layers, view.plans, view.nums):
                rgba, alpha, _, izs = renderer._layer_tier_batch(
                    renderer._chunk_layer(lay, sl), "march", None, plan, k_l,
                    0, view.pos_b[sl], None, None, None, None,
                    refine=cfg.march_refine, rot_refine=0, t_refine=0,
                    feathering=cfg.feathering, mask_mode=view.mask_mode,
                    raw=True)
                if acc_rgb is None:
                    acc_rgb = alpha[..., None] * rgba[..., :3]
                    acc_a = alpha
                    front = torch.where(alpha > 0.0, izs, 0.0)
                else:
                    acc_rgb = acc_rgb + (
                        1.0 - acc_a[..., None]
                    ) * alpha[..., None] * rgba[..., :3]
                    new_hit = (alpha > 0.0) & (front == 0.0)
                    front = torch.where(new_hit, izs, front)
                    acc_a = acc_a + (1.0 - acc_a) * alpha
            view_rgb.append(acc_rgb)
            view_a.append(acc_a)
            view_front.append(front)
        color, alpha = composite.fuse_views(
            torch.stack(view_rgb), torch.stack(view_a),
            torch.stack(view_front), float(cfg.fuse_tol))
        out[sl] = composite.finish_over_background(color, alpha, background,
                                                   to_srgb)
    return out


# (projectors, layers, poses, pose_chunk, fuse_tol, to_srgb, skewed)
CASES = {
    "one-projector": (1, 1, 3, 48, 0.05, True, False),
    "two-hard": (2, 1, 3, 48, 0.0, True, False),
    "four-chunks": (4, 1, 5, 2, 0.05, True, False),
    "ldi-multiply-linear": (2, 2, 3, 2, 0.05, False, False),
    "ldi-hard-merge": (4, 2, 3, 48, 0.0, True, False),
    "skewed": (2, 1, 4, 3, 0.05, True, True),
    "nine-projectors": (9, 1, 2, 48, 0.05, True, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_route_equals_the_chain(case):
    """render_fused_fast_batch on the CPU (the marches, then the fused
    epilogue's plain version) equals the frozen chain bit for bit."""
    n, layers, poses, chunk, tol, to_srgb, skewed = case = CASES[case]
    skew = (0.021, -0.0137) if skewed else (0.0, 0.0)
    projs = _projectors(n, layers, skew)
    cams = _cams(poses, (0.004, 0.0061) if skewed else (0.0, 0.0))
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=chunk,
                                               fuse_tol=tol)
    got = lif_tpu_torch.render_fused_fast_batch(
        projs, cams, config=cfg, background=BACKGROUND, to_srgb=to_srgb)
    ref = _chain(projs, cams, cfg, BACKGROUND, to_srgb)
    assert got.shape == ref.shape == (poses, H, W, 4)
    assert 0.0 < float(got[..., 3].mean()) <= 1.0
    assert torch.equal(got, ref)


@pytest.mark.parametrize("counts", [
    [1], [1, 1, 1, 1], [2, 2, 2, 2], [1] * 8, [4] * 8, [1] * 9, [5] * 7,
    [1] * 17, [2, 1, 3] * 6,
], ids=lambda c: "-".join(map(str, c)))
def test_entry_table_holds_any_projectors_and_layers(counts):
    """The kernel's entry table for any number of projectors and layers:
    one 72-byte record a layer, projector by projector and front to back
    (its tensors' addresses, the march's width, the mask mode with 4 on
    each projector's last layer, and the hit test's numbers rounded to
    float32 as the kernel takes them); the kernel takes the first
    INLINE_ENTRIES in its parameters, the rest from the device."""
    from lif_tpu_torch.ops import sweep_march as tsm

    b, h, w = 2, 8, 24
    modes = ["none", "multiply", "hard"]
    views, want = [], []
    for v, n in enumerate(counts):
        lays = []
        for l in range(n):
            plan = tsm.translation_plan(w + 2 * v, h + l, w, h, 4.0, 0.0)
            lay = tfe.FusedLayer(
                torch.zeros((b, h, w)), torch.zeros((b, h, w)),
                torch.zeros((b, h, w, 4)), torch.zeros((b, 3)), plan,
                30.1 + v, (0.5 * l, -0.25), l)
            lays.append(lay)
            want.append((lay, modes[v % 3], l == n - 1))
        views.append((modes[v % 3], lays))
    rec = tfe._entry_table(views)
    assert rec.dtype == tfe._ENTRY and rec.dtype.itemsize == 72
    assert len(rec) == sum(counts) and rec.flags["C_CONTIGUOUS"]
    assert int((rec["flags"] & 4).astype(bool).sum()) == len(counts)
    for r, (lay, mode, last) in zip(rec, want):
        plan, crop = lay.plan, lay.crop_y
        assert r["ptr"].tolist() == [lay.found.data_ptr(),
                                     lay.invz_star.data_ptr(),
                                     lay.rgba_star.data_ptr(),
                                     lay.poses.data_ptr()]
        assert r["w"] == w
        assert r["flags"] == {"none": 0, "multiply": 1,
                              "hard": 2}[mode] + 4 * last
        geom = np.array([lay.f1, (plan.src_w - w) / 2.0,
                         (plan.src_h - h) / 2.0, lay.offset[0],
                         lay.offset[1], crop, 0.0, 0.0], np.float32)
        geom[6] = np.float32(1.0) / np.float32(plan.src_w)
        geom[7] = np.float32(1.0) / np.float32(plan.src_h + 2 * crop)
        assert r["geom"].tobytes() == geom.tobytes()
    far = rec[tfe.INLINE_ENTRIES:].view(np.uint8)
    assert far.size == 72 * max(0, sum(counts) - tfe.INLINE_ENTRIES)


@pytest.mark.parametrize("n,chunk", [(4, 2), (9, 48)])
def test_counter_counts_each_plain_call(n, chunk):
    """On the CPU each pose chunk calls the plain version once, counted
    as epilogue.fused.merge in the lif.epilogue.fused span, inside the
    call's lif.chunk spans; the marches run in lif.kernel.lateral."""
    from torch.profiler import ProfilerActivity, profile

    projs = _projectors(n, 1)
    cams = _cams(5)
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=chunk)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        lif_tpu_torch.render_fused_fast_batch(projs, cams, config=cfg)
    snap = profiling.snapshot()
    chunks = len(renderer._pose_chunks(5, chunk))
    assert snap["counters"]["epilogue.fused.merge"] == chunks
    assert snap["spans"]["lif.epilogue.fused"]["n"] == chunks
    assert snap["spans"]["lif.chunk"]["n"] == chunks
    assert snap["spans"]["lif.kernel.lateral"]["n"] == chunks * n
    recs = profiling.records()
    for r in recs:
        if r["name"] == "lif.epilogue.fused":
            assert recs[r["parent"]]["name"] == "lif.chunk"


def test_plain_version_takes_lazy_layers_and_a_padded_width():
    """fused_epilogue_plain consumes each projector's layers as an
    iterable (the chain's lazy marches) and writes the true width of
    march outputs padded past it; the CPU dispatcher is the plain
    version."""
    from lif_tpu_torch.ops import sweep_march as tsm

    rng = np.random.default_rng(3)
    b, h, w, w_true = 2, 8, 24, 20
    plan = tsm.translation_plan(w, h, w, h, 4.0, 0.0)

    def layer(seed):
        g = np.random.default_rng(seed)
        return tfe.FusedLayer(
            torch.from_numpy((g.random((b, h, w)) > 0.3).astype(np.float32)),
            torch.from_numpy(g.uniform(0.2, 0.9, (b, h, w)).astype(
                np.float32)),
            torch.from_numpy(g.random((b, h, w, 4)).astype(np.float32)),
            torch.from_numpy(np.array([[0.01, 0.0, 0.0], [0.02, 0.0, 0.0]],
                                      np.float32)),
            plan, 30.0, (0.5, -0.25), 2)

    views = [("multiply", [layer(1), layer(2)]), ("none", [layer(3)])]
    kw = dict(background=BACKGROUND, feathering=0.1, fuse_tol=0.05,
              to_srgb=True)
    full = torch.empty((b, h, w, 4))
    tfe.fused_epilogue_plain(views, full, **kw)
    out = torch.full((b, h, w_true, 4), float(rng.random()))
    lazy = [(mode, iter(lays)) for mode, lays in views]
    assert tfe.fused_epilogue_plain(lazy, out, **kw) is out
    assert torch.equal(out, full[:, :, :w_true])
    again = torch.empty_like(out)
    tfe.fused_epilogue(views, again, **kw)
    assert torch.equal(again, out)
