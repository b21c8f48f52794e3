"""The lateral epilogue's plain route, on the CPU.

A call whose every layer marches finishes each layer of each pose chunk
straight into the call's frames (models/renderer.py::_fast_batch_core's
in-place route, ops/cuda/sweep_march.py::lateral_epilogue), on the card
through the epilogue kernel and on the CPU through its plain version, the
PyTorch chain it replaces. Here the CPU's default route is held bit for
bit to the chain that calls with a 'rotated' or 'sweep' layer take
(forced by turning the route off):
_finalize over a zero background, the front-to-back over of the LDI
layers, finish_over_background, the concatenation of the pose chunks and
the width-pad slice. The kernel is held to the same chain on the card
(tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import lif_tpu_torch
from lif_tpu_torch.models import renderer
from lif_tpu_torch.ops import sweep_march as tsm
from lif_tpu_torch.ops.cuda import sweep_march as tcuda

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


def _projector(layers, h, w, skew=(0.0, 0.0)):
    """One layer, or three: the back two outpainted by even margins (16
    and 8 rows, 32 and 16 columns), every layer masked."""
    rgb0, disp0, mask0 = _scene(w + h, h, w)
    extra = []
    for i, (dh, dw) in enumerate(((16, 32), (8, 16))[: layers - 1]):
        rgb, disp, mask = _scene(w + h + i + 1, h + dh, w + dw)
        extra.append(dict(rgb=rgb, disp=disp, mask=mask, focal_px=0.78 * w,
                          invz_min=0.5 - 0.1 * i, invz_max=0.1))
    return lif_tpu_torch.projector_from_arrays(
        rgb0, disp0, mask0 if layers > 1 else None, focal_px=0.78 * w,
        invz_min=2.0, invz_max=0.6, baseline=1.0, skew=skew, device="cpu",
        extra_layers=extra)


# (layers, width, poses, pose_chunk, mask_mode, to_srgb, skew, background)
CASES = {
    "one-layer-ragged-chunks": (1, 64, 7, 3, None, True, False, BACKGROUND),
    "ldi-none": (3, 64, 4, 2, "none", True, False, BACKGROUND),
    "ldi-multiply": (3, 64, 4, 2, "multiply", True, False, BACKGROUND),
    "ldi-hard": (3, 64, 4, 2, "hard", True, False, BACKGROUND),
    "ldi-linear": (3, 64, 3, 2, "multiply", False, False, BACKGROUND),
    "ldi-odd-width": (3, 60, 3, 2, "multiply", True, False, BACKGROUND),
    "ldi-skew-outpainted": (3, 64, 3, 2, "multiply", True, True, BACKGROUND),
    "tensor-background": (1, 60, 3, 2, None, True, False,
                          torch.tensor(BACKGROUND)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_route_plain_equals_the_torch_chain(case, monkeypatch):
    """render_fast_batch on the CPU's default route, the fused route's
    plain version, equals the same call through the chain bit for bit;
    the route finishes each layer of each pose chunk once (chunks x
    layers epilogues)."""
    layers, w, n, chunk, mask_mode, to_srgb, skewed, bg = CASES[case]
    h = 40
    skew = (0.021, -0.0137) if skewed else (0.0, 0.0)
    proj = _projector(layers, h, w, skew)
    cams = [lif_tpu_torch.Camera.create(
        w, h, focal_px=0.78 * w, position=[0.01 + 0.007 * i, 0.0, 0.0],
        skew=(0.004, 0.0061) if skewed else (0.0, 0.0)) for i in range(n)]
    cfg = lif_tpu_torch.DEFAULT_CONFIG.replace(pose_chunk=chunk)
    kw = dict(config=cfg, background=bg, to_srgb=to_srgb,
              mask_mode=mask_mode, method="march")
    with monkeypatch.context() as m:
        m.setattr(renderer, "_fuses_epilogue", lambda modes: False)
        ref, tiers = lif_tpu_torch.render_fast_batch(proj, cams,
                                                     return_tiers=True, **kw)
    assert tiers == ("march",) * layers

    finished = []
    plain = tcuda.lateral_epilogue_plain

    def spy(*args, **kwargs):
        finished.append((kwargs["first"], kwargs["last"]))
        return plain(*args, **kwargs)

    monkeypatch.setattr(tcuda, "lateral_epilogue_plain", spy)
    got = lif_tpu_torch.render_fast_batch(proj, cams, **kw)
    n_chunks = len(renderer._pose_chunks(n, chunk))
    assert finished == [(i == 0, i == layers - 1)
                        for i in range(layers)] * n_chunks
    assert got.shape == ref.shape == (n, h, w, 4)
    assert torch.equal(got, ref)
    if skewed:  # the y fold and the outpaint crop were exercised
        lays = renderer._prepared_textures(proj)
        assert lays[1]["h"] > h
        assert n_chunks > 1


def test_epilogue_writes_only_its_rows():
    """render_translation_batch(out=out[1:4]) writes those rows, the
    layer over the background as render_translation_batch returns it,
    and leaves every other row of `out` as it was."""
    h, w = 40, 64
    proj = _projector(1, h, w)
    lay = renderer._prepared_textures(proj)[0]
    f1, izmin, izmax = lay["focal_host"], lay["izmin_host"], lay["izmax_host"]
    cxs = [0.02, 0.031, 0.045]
    c1 = np.stack([np.asarray(cxs, np.float32), np.zeros(3, np.float32),
                   np.zeros(3, np.float32)], -1)
    plan = renderer._march_plan(lay, max(cxs), w, h)
    planes, k = tsm.snap_plane_tables_batch(f1, cxs, izmin, izmax)
    args = (lay["rgb"], lay["disp"], lay["mask"], izmin, izmax, c1, f1,
            torch.from_numpy(planes), BACKGROUND, plan, k)
    kw = dict(feathering=0.1, mask_mode="none", to_srgb=False)
    out = torch.full((5, h, w, 4), float("nan"))
    ret = tsm.render_translation_batch(*args, **kw, out=out[1:4])
    assert ret.data_ptr() == out[1:4].data_ptr()
    assert torch.equal(out[1:4], tsm.render_translation_batch(*args, **kw))
    assert bool(out[0].isnan().all()) and bool(out[4].isnan().all())


@pytest.mark.parametrize("modes,fused", [
    (("march",), True),
    (("march", "march", "march"), True),
    (("march", "sweep"), False),
    (("scaled", "rotated"), False),
    (("target", "sweep"), False),
    (("rotated",), False),
    (("march", "march"), True),
    (("sweep", "march"), False),
    (("scaled",), True),
    (("target",), True),
    (("target", "march"), True),
    (("scaled", "march"), True),
    (("march", "target", "scaled"), True),
    (("target", "rotated"), False),
])
def test_route_predicate(modes, fused):
    """A call takes the in-place route where every layer's tier has an
    epilogue kernel ('march', 'target', 'scaled'), decided by its tiers
    alone (on any device); a 'rotated' or 'sweep' layer keeps the
    chain."""
    assert renderer._fuses_epilogue(modes) is fused
