"""The references against the program's CPU path at a tiny size: the
lateral reference equals what each entry point renders, and the exact
march follows the program's own exact march. The tests may import the
program; the references may not."""

import numpy as np
import pytest
import torch

from benchmark.lifbench import parts, traffic
from benchmark.lifbench.check import Slot
from benchmark.reference import exact, lateral

lt = pytest.importorskip("lif_tpu_torch")
scene = parts.load("scenes", "noise-views")

TINY = {"width": 64, "height": 40, "focal_ratio": 0.78, "invz_near": 0.09,
        "invz_far": 0.0001, "baseline_m": 0.045, "projectors": 1,
        "projector_dx_m": 0.02,
        "render_config": {"feathering": 0.1, "fuse_tol": 0.05}}


def setup(seed, **changes):
    cfg = {**TINY, **changes}
    srcs = scene.build(cfg, seed, torch.device("cpu"))
    return cfg, srcs, scene.projectors(lt, srcs, cfg)


def poses(xs):
    return {"position": np.array([[x, 0.0, 0.0] for x in xs])}


@pytest.mark.parametrize("seed", [2**31 + 5, 2**40 + 17])
def test_lateral_equals_the_batch(seed):
    cfg, (src,), (proj,) = setup(seed)
    xs = [0.12 + 0.02 * i / 6 for i in range(6)] + [-0.05]
    call = poses(xs)
    out = lt.render_fast_batch(proj, traffic.cameras(lt, call, cfg),
                               method="march")
    for j in range(len(xs)):
        ref, work = lateral.render_slot([src], Slot(out[j], j, call), cfg,
                                        {"ladder": "call"})
        assert torch.equal(out[j], ref), float((out[j] - ref).abs().max())
        w = work["lateral_march"]
        assert 0 < w["found"] <= w["pixels"] == 64 * 40 == w["out_px"]
        assert w["pixels"] <= w["planes"] and w["source_texels"] == 64 * 40


@pytest.mark.parametrize("x", [0.135, -0.02, 0.0003])
def test_lateral_equals_the_single_view(x):
    cfg, (src,), (proj,) = setup(2**33 + 1)
    cam = traffic.cameras(lt, poses([x]), cfg)[0]
    ref, _ = lateral.render(src, x, None)
    assert torch.equal(lt.render_fast_view(proj, cam), ref)


def test_lateral_equals_the_fused_batch():
    cfg, srcs, projs = setup(2**35 + 3, width=96, height=56, projectors=4)
    xs = [0.05 + 0.002 * j for j in range(4)]
    cams = traffic.cameras(lt, poses(xs), cfg)
    out = lt.render_fused_fast_batch(projs, cams, config=lt.RenderConfig(
        fuse_tol=0.05))
    for j, x in enumerate(xs):
        ref, marches = lateral.render_fused(srcs, x, xs, 0.05)
        assert len(marches) == 4
        assert torch.equal(out[j], ref), float((out[j] - ref).abs().max())


@pytest.mark.parametrize("x", [0.135, -0.06])
def test_exact_follows_the_program_exact_march(x):
    cfg, (src,), (proj,) = setup(2**31 + 9)
    cam = traffic.cameras(lt, poses([x]), cfg)[0]
    ours = exact.render_slot([src], Slot(None, 0, poses([x])), cfg)
    theirs = lt.render_mono_view(proj, cam, num_steps=exact.NUM_STEPS)
    gap = (ours - theirs).abs()
    # the same march; the float32 transforms differ in the last bit
    assert float(gap.mean()) < 1e-4
    assert float((gap > 1e-3).float().mean()) < 0.01


def test_scene_is_seeded():
    a = scene.build(TINY, 2**31 + 2, torch.device("cpu"))[0]
    b = scene.build(TINY, 2**31 + 2, torch.device("cpu"))[0]
    c = scene.build(TINY, 2**31 + 3, torch.device("cpu"))[0]
    assert torch.equal(a.disp, b.disp) and torch.equal(a.rgb, b.rgb)
    assert not torch.equal(a.disp, c.disp)
    assert 0.2 <= float(a.disp.min()) and float(a.disp.max()) <= 0.95


def test_bfloat16_reference_departs():
    """The control's precision moves the frames: the reference in
    bfloat16 is not the reference."""
    _, (src,), _ = setup(2**31 + 4)
    f32, _ = lateral.render(src, 0.135, [0.135])
    bf16, _ = lateral.render(src, 0.135, [0.135], dtype=torch.bfloat16)
    assert float((f32 - bf16).abs().mean()) > 1e-4


def test_poses_are_seeded():
    sweep = {"poses_per_call": 1, "path": {
        "kind": "sweep", "origin": [[-0.135, 0.135], [0, 0], [0, 0]],
        "step_min": [0.0025, 0, 0], "step_max": [0.0075, 0, 0],
        "bound": [0.135, 0, 0]}}
    s1 = traffic.PoseStream(sweep, np.random.default_rng([2**31 + 1, 1]))
    s2 = traffic.PoseStream(sweep, np.random.default_rng([2**31 + 1, 1]))
    p1 = np.concatenate([s1.next()["position"] for _ in range(2000)])
    p2 = np.concatenate([s2.next()["position"] for _ in range(2000)])
    assert np.array_equal(p1, p2)
    assert np.abs(p1[:, 0]).max() <= 0.135 and not p1[:, 1:].any()
    assert np.abs(np.diff(p1[:, 0])).max() <= 0.0075 + 1e-12
    # the sweep covers the range evenly
    counts = np.histogram(p1[:, 0], bins=6, range=(-0.135, 0.135))[0]
    assert counts.min() > 0.6 * counts.mean()


def test_strata_give_every_seed_the_same_origins():
    line = {"poses_per_call": 4, "path": {
        "kind": "line", "origin": [[0.04, 0.06], [0, 0], [0, 0]],
        "strata": 8, "span": [0.008, 0, 0]}}
    for seed in (2**31 + 1, 2**31 + 2):
        s = traffic.PoseStream(line, np.random.default_rng([seed, 1]))
        x0 = sorted(s.next()["position"][0, 0] for _ in range(8))
        assert [int((x - 0.04) / 0.0025) for x in x0] == list(range(8))


@pytest.mark.parametrize("moved", ["y", "rotation"])
def test_lateral_reference_refuses_what_it_does_not_cover(moved):
    """A pose the lateral reference does not render is refused, never
    compared against a lateral frame."""
    cfg, srcs, _ = setup(2**31 + 6)
    call = poses([0.1])
    if moved == "y":
        call["position"][0, 1] = 0.01
    else:
        c, s_ = np.cos(0.1), np.sin(0.1)
        call["rotation"] = np.array([[[c, 0, s_], [0, 1, 0], [-s_, 0, c]]])
    with pytest.raises(ValueError):
        lateral.render_slot(srcs, Slot(None, 0, call), cfg, {"ladder": "call"})
