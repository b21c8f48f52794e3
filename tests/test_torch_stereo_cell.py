"""The benchmark's stereo cell (sfmoma.stereo) on the CPU at a tiny size:
a 64 x 40 view of a seeded two-view, 3-layer LDI (benchmark/scenes/
stereo-ldi-layers.py), each layer outpainted by 16 px, rendered by
render_stereo_fast_batch as 8 stereo pairs in two pose chunks and held to
the cell's plain reference (benchmark/reference/stereo_ldi.py) within the
cell's check limits; the counters a traced call leaves; and the pairs
path's eyes."""

from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import lif_tpu_torch as lt
from benchmark.lifbench import check, harness, parts, traffic
from lif_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CELL = "sfmoma.stereo"
SEED = 2**31 + 2407
W, H, OUTPAINT = 64, 40, 16
N, CHUNK = 16, 8  # eyes a call (8 pairs), eyes a chunk: two chunks


def tiny():
    """The cell's overrides at a 64 x 40 view with 16 px of outpainting:
    the layers' stored ranges under the loader's rule at this width."""
    cfg = parts.load_json(ROOT / "benchmark/configs/sfmoma-stereo-ldi3.json")
    grow = 1.0 + OUTPAINT / W
    return {
        "config": {
            "width": W, "height": H, "outpaint_px": OUTPAINT,
            "layer_width": W + OUTPAINT, "layer_height": H + OUTPAINT,
            "layer_invz": [[near / grow, far / grow] for near, far
                           in cfg["assumed"]["layer_invz_stored"]],
            "render_config": dict(cfg["render_config"], pose_chunk=CHUNK),
        },
        "traffic": {"poses_per_call": N},
    }


@pytest.fixture(scope="module")
def scene():
    """(cell, the reference's two views, the program's two projectors)."""
    cell = harness.Cell(ROOT, CELL, tiny())
    part = parts.load("scenes", cell.config["scene"])
    srcs = part.build(cell.config, SEED, torch.device("cpu"))
    return cell, srcs, part.projectors(lt, srcs, cell.config)


def _poses(cell, seed):
    """A call of the cell's pairs path drawn from `seed`."""
    return traffic.PoseStream(cell.traffic,
                              np.random.default_rng(seed)).next()


def _render(cell, projs, poses):
    cams = traffic.cameras(lt, poses, cell.config)
    return lt.render_stereo_fast_batch(
        *projs, cams, config=lt.RenderConfig(**cell.config["render_config"]),
        return_tiers=True)


@pytest.mark.parametrize("seed", [11, 12])
def test_program_equals_the_reference(scene, seed):
    """Every layer of both eyes marches, and each frame equals the
    reference within the cell's limits."""
    cell, srcs, projs = scene
    poses = _poses(cell, seed)
    out, tiers = _render(cell, projs, poses)
    assert tiers == (("march",) * 3,) * 2
    ref = parts.load("reference", cell.check["reference"])
    pairs = []
    for j in range(N):
        frame, work = ref.render_slot(srcs, check.Slot(out[j], j, poses),
                                      cell.config, cell.check["options"])
        assert work["lateral_march"]["pixels"] == 6 * W * H
        pairs.append((out[j], frame))
    ok, rows = check.judge(check.gaps(pairs), cell.check["limits"])
    assert ok, rows
    # the right view is coherent with the left, and both show through
    # their front layer's mask
    left, right = srcs
    assert 0.0 < float(left[0].mask.mean()) < 1.0
    assert 0.0 < float(right[0].mask.mean()) < 1.0
    assert float((out[..., 3] > 0.5).float().mean()) > 0.5


@pytest.fixture(scope="module")
def stepped():
    """The tiny scene with every left layer's disparity made of 8 x 8
    texel blocks of 0.1 or 0.9 (seeded) and the right view re-marched
    from it: depth edges sharp enough that the stretch-mark confidence
    dies at this focal, where the scene's own noise is too smooth."""
    cell = harness.Cell(ROOT, CELL, tiny())
    part = parts.load("scenes", cell.config["scene"])
    srcs = part.build(cell.config, SEED, torch.device("cpu"))
    left, right = srcs
    gen = torch.Generator().manual_seed(SEED)
    n, h, w = left.disp.shape
    blocks = torch.rand((n, -(-h // 8), -(-w // 8)), generator=gen) > 0.5
    steps = 0.1 + 0.8 * blocks.float()
    left.disp.copy_(steps.repeat_interleave(8, 1).repeat_interleave(8, 2)
                    [:, :h, :w])
    for i, layer in enumerate(left):
        right.rgb[i], right.disp[i], right.mask[i] = part.remarch(
            layer, cell.config["view_x_m"][1])
    return cell, srcs, part.projectors(lt, srcs, cell.config)


def test_confidence_and_fill_on_depth_edges(stepped):
    """On sharp depth edges the stretch-mark confidence dies and the
    occlusion fill takes the other view (at the call's last eye, farthest
    from the left view), and the program still equals the reference
    within the cell's limits."""
    cell, srcs, projs = stepped
    poses = _poses(cell, 14)
    out, _ = _render(cell, projs, poses)
    ref = parts.load("reference", cell.check["reference"])
    xs = [float(v) for v in poses["position"][:, 0]]
    f2 = cell.config["focal_ratio"] * W
    killed = filled = 0.0
    for lay_l, lay_r in zip(*srcs):
        (v_l, c_l, _), (v_r, c_r, _) = (
            ref.march_eye(lay, xs[-1], xs, W, H, 0.1, f2, torch.float32)
            for lay in (lay_l, lay_r))
        killed += float((c_l == 0.0).float().mean())
        filled += float((((c_l == 0.0) & (c_r == 1.0))
                         | (v_l[..., 3] < v_r[..., 3] - 0.1)).float().mean())
    assert killed > 0.01 and filled > 0.01
    pairs = [(out[j], ref.render_slot(srcs, check.Slot(out[j], j, poses),
                                      cell.config, cell.check["options"])[0])
             for j in range(N)]
    ok, rows = check.judge(check.gaps(pairs), cell.check["limits"])
    assert ok, rows


def test_traced_call_counts(scene):
    """A traced call of 8 pairs in two chunks plans 6 lateral layers (3
    a view), routes 6 eye-layers to the march and blends 3 layers in
    each chunk."""
    cell, _, projs = scene
    poses = _poses(cell, 13)
    _render(cell, projs, poses)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        _render(cell, projs, poses)
    snap = profiling.snapshot()
    assert snap["calls"] == 1
    counters = snap["counters"]
    assert counters["plan.march_layer"] == 6
    assert counters["route.march"] == 6
    assert counters["stereo.blend"] == 6
    assert not {k for k in counters if k.startswith("route.")} - {
        "route.march"}
    assert {"lif.stereo.conf", "lif.stereo.blend"} <= set(snap["spans"])


@pytest.mark.parametrize("seed", [21, 22])
def test_pairs_put_the_eyes_about_each_head(scene, seed):
    """Each pair is one head's left then right eye at the head -/+ eye_m
    on x; the heads slide by span over the call from an origin inside the
    traffic's range; no rotation."""
    cell, _, _ = scene
    path = cell.traffic["path"]
    pos = _poses(cell, seed)["position"]
    assert pos.shape == (N, 3)
    left, right = pos[0::2], pos[1::2]
    heads = (left + right) / 2.0
    np.testing.assert_allclose(right - left, [[2 * path["eye_m"], 0, 0]] * (
        N // 2), atol=1e-15)
    step = np.asarray(path["span"]) / (N // 2)
    np.testing.assert_allclose(np.diff(heads, axis=0), [step] * (N // 2 - 1),
                               atol=1e-15)
    lo, hi = np.asarray(path["origin"]).T
    assert ((lo <= heads[0]) & (heads[0] <= hi)).all()
    assert "rotation" not in _poses(cell, seed)
