"""The camera-path cell on the CPU at a tiny size (a 128 x 48 frame, three
8-pose segments): each segment's frames against the reference of its
tier, the control and the planted faults, the path's orbit against the
program's orbit_pose, the posed exact march against the unrotated one
and the program's, and the cell's readers on fabricated traces."""

import copy
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.lifbench import check, faults, harness, parts, traffic
from benchmark.reference import exact, exact_posed

lt = pytest.importorskip("lif_tpu_torch")

ROOT = Path(__file__).resolve().parents[2]
CELL = "sfmoma.camera-path"
SEED = 2**31 + 303
N = 8  # poses a segment
TIERS = ("lateral", "target", "scaled")


def tiny():
    """The cell's overrides at 128 x 48 with three N-pose segments."""
    spec = parts.data("traffic", "camera-path-432")
    path = copy.deepcopy(spec["path"])
    for seg in path["segments"]:
        seg["poses"] = N
    return {
        "config": {"width": 128, "height": 48},
        "traffic": {"poses_per_call": 3 * N, "path": path,
                    "entry_kwargs": {"segments": [N] * 3, "method": "auto"}},
        "check": {"sample_frames": 12, "strata": {"slot": 12},
                  "options": {"segments": [[t, N] for t in TIERS]}},
    }


def tiny_run(seconds=0.3, trace=False, wrap=None):
    return harness.run(ROOT, CELL, SEED, seconds, trace, time.perf_counter(),
                       device="cpu", wrap=wrap, overrides=tiny())


@pytest.fixture(scope="module")
def clip():
    """One clip of the tiny cell: (cell, sources, poses, the program's
    frames)."""
    cell = harness.Cell(ROOT, CELL, tiny())
    scene = parts.load("scenes", cell.config["scene"])
    srcs = scene.build(cell.config, SEED, torch.device("cpu"))
    projs = scene.projectors(lt, srcs, cell.config)
    poses = traffic.PoseStream(cell.traffic,
                               np.random.default_rng(SEED)).next()
    entry = parts.load("entries", cell.traffic["entry"]).make(
        lt, projs, cell.config["render_config"],
        cell.traffic["entry_kwargs"])
    cams = traffic.cameras(lt, poses, cell.config)
    return cell, srcs, projs, cams, poses, entry(cams)


@pytest.mark.parametrize("seg", range(3), ids=TIERS)
def test_segment_equals_its_tier_reference(clip, seg):
    """Each segment renders on its tier, and its frames equal the
    reference of that tier within the cell's limits."""
    cell, srcs, projs, cams, poses, frames = clip
    sl = slice(seg * N, (seg + 1) * N)
    _, tiers = lt.render_fast_batch(projs[0], cams[sl], return_tiers=True,
                                    config=lt.RenderConfig(
                                        **cell.config["render_config"]))
    assert tiers == ({"lateral": "march"}.get(TIERS[seg], TIERS[seg]),)
    ref = parts.load("reference", "camera-path")
    pairs = []
    for j in range(sl.start, sl.stop):
        frame, work = ref.render_slot(srcs, check.Slot(frames[j], j, poses),
                                      cell.config, cell.check["options"])
        w = work[f"{TIERS[seg]}_march"]
        assert w["poses"] == N and w["out_px"] == 128 * 48 == w["pixels"]
        assert 0 < w["found"] <= w["pixels"] <= w["planes"]
        pairs.append((frames[j], frame))
    ok, rows = check.judge(check.gaps(pairs), cell.check["limits"])
    assert ok, rows


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    res, _ = tiny_run(trace=trace)
    assert res["correct"] is True and res["attempted"] % (3 * N) == 0
    if trace:
        # no device on the CPU: the readers return nothing, never 0
        assert res["metrics"] == {}
    else:
        assert set(res["metrics"]) == {"setup_s", "frames_per_s", "psnr_db"}
        assert res["metrics"]["psnr_db"]["value"] > 30.0


def test_control_fails():
    """The references in bfloat16, put in the program's place, fail the
    check while the program passes it."""
    sides = dict(control.readings(ROOT, CELL, SEED, 0.3, True, "cpu",
                                  tiny()))
    limits = harness.Cell(ROOT, CELL).check["limits"]
    assert check.judge(sides["program"], limits)[0]
    assert not check.judge(sides["control"], limits)[0]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_found(fault):
    res, _ = tiny_run(wrap=faults.FAULTS[fault])
    assert res["correct"] is False, res["check"]


@pytest.mark.parametrize("seed", [2**31 + 1, 2**35 + 9])
def test_orbit_poses_are_the_programs(seed):
    """The path's orbit equals lif_tpu_torch's orbit_pose at the same
    angles, positions and rotations to 1e-12; the lateral and zoom
    segments carry the identity."""
    spec = parts.data("traffic", "camera-path-432")
    stream = traffic.PoseStream(spec, np.random.default_rng([seed, 1]))
    orbit = next(s for s in spec["path"]["segments"]
                 if s["kind"] == "orbit")
    for _ in range(3):
        poses = stream.next()
        pos, rot = poses["position"][144:288], poses["rotation"][144:288]
        d = np.rad2deg(np.arctan2(pos[:, 0], pos[:, 2] + 1.0))
        theta0 = d[0]
        assert -15.0 <= theta0 <= -13.0 and d[-1] <= 15.0
        for i in (0, 71, 143):
            theta = np.deg2rad(theta0 + orbit["sweep_deg"] * i / 144)
            p, r = lt.orbit_pose(orbit["center"], orbit["radius"], theta)
            assert np.abs(pos[i] - p).max() <= 1e-12
            assert np.abs(rot[i] - r).max() <= 1e-12
        assert np.array_equal(poses["rotation"][:144],
                              np.broadcast_to(np.eye(3), (144, 3, 3)))
        assert np.array_equal(poses["rotation"][288:],
                              np.broadcast_to(np.eye(3), (144, 3, 3)))


@pytest.mark.parametrize("pos", [[0.135, 0.0, 0.0], [0.0, 0.0, 0.15],
                                 [-0.06, 0.01, 0.05]])
def test_exact_posed_is_exact_when_unrotated(pos):
    cfg = {**parts.load_json(ROOT / "benchmark/configs/sfmoma-1280x800.json"),
           "width": 64, "height": 40}
    srcs = parts.load("scenes", "noise-views").build(cfg, SEED,
                                                     torch.device("cpu"))
    slot = check.Slot(None, 0, {"position": np.array([pos])})
    posed = exact_posed.render_slot(srcs, slot, cfg)
    assert torch.equal(posed, exact.render_slot(srcs, slot, cfg))


@pytest.mark.parametrize("theta", [-14.0, 9.0])
def test_exact_posed_follows_the_program_exact_march(theta):
    cfg = {**parts.load_json(ROOT / "benchmark/configs/sfmoma-1280x800.json"),
           "width": 64, "height": 40}
    scene = parts.load("scenes", "noise-views")
    srcs = scene.build(cfg, SEED, torch.device("cpu"))
    (proj,) = scene.projectors(lt, srcs, cfg)
    p, r = lt.orbit_pose([0.0, 0.0, -1.0], 1.0, np.deg2rad(theta))
    poses = {"position": np.array([p]), "rotation": np.array([r])}
    ours = exact_posed.render_slot(srcs, check.Slot(None, 0, poses), cfg)
    cam = traffic.cameras(lt, poses, cfg)[0]
    theirs = lt.render_mono_view(proj, cam, num_steps=exact.NUM_STEPS)
    gap = (ours - theirs).abs()
    # the same march; the float32 transforms differ in the last bit
    assert float(gap.mean()) < 1e-4
    assert float((gap > 1e-3).float().mean()) < 0.01


FROZEN = parts.load("reference", "camera-path").FROZEN


def test_config_is_the_published_projector():
    """The cell's configuration is sfmoma-1280x800 at its published size,
    with the tier knobs the references freeze stated besides."""
    ours = harness.Cell(ROOT, CELL).config
    base = parts.load_json(ROOT / "benchmark/configs/sfmoma-1280x800.json")
    own = {"name", "source", "deployment", "reference", "render_config"}
    assert set(ours) == set(base)
    assert {k: ours[k] for k in set(ours) - own} == \
        {k: base[k] for k in set(base) - own}
    assert {k: ours["render_config"][k]
            for k in base["render_config"]} == base["render_config"]
    assert set(ours["render_config"]) - set(base["render_config"]) == \
        {*FROZEN, "pose_chunk"}


@pytest.mark.parametrize("key", [*sorted(FROZEN), "pose_chunk"])
def test_config_states_the_frozen_knobs(key):
    """Each knob the references freeze is the program's default, and the
    configuration states it at that value."""
    rc = harness.Cell(ROOT, CELL).config["render_config"]
    assert rc[key] == getattr(lt.RenderConfig(), key)
    if key in FROZEN:
        assert rc[key] == FROZEN[key]


@pytest.mark.parametrize("key", sorted(FROZEN))
def test_reference_refuses_another_knob(key):
    config = harness.Cell(ROOT, CELL).config
    config = {**config, "render_config": {**config["render_config"],
                                          key: FROZEN[key] + 1}}
    with pytest.raises(ValueError, match=key):
        parts.load("reference", "camera-path").render_slot(
            [None], None, config, {"segments": [["target", 1]]})


# ---------------------------------------------------------------------------
# the readers, on a fabricated window of two clips
# ---------------------------------------------------------------------------


def op(name, t0, t1, kernel=True):
    return SimpleNamespace(name=name, start_ns=t0, end_ns=t1,
                           kernel=kernel)


def window(copies=True, target_kernel="target_march_kernel"):
    """Two clips' device activity: per segment a kernel of its tier, a
    small table copy, an elementwise kernel and the 2 ms clip copy, 4 ms
    in all; between the clips the harness's copy of a sampled frame."""
    ops, t = [], 0
    ms = 10**6
    for clip in range(2):
        if clip:
            ops.append(op("Memcpy DtoD (Device -> Device)", t, t + 12000,
                          kernel=False))
            t += ms
        for k in ("lateral_march_kernel", target_kernel,
                  "scaled_march_kernel"):
            ops += [op(f"void {k}<false>()", t, t + ms),
                    op("Memcpy DtoD (Device -> Device)", t + ms,
                       t + ms + 2000, kernel=False),
                    op("elementwise_kernel", t + ms, t + 2 * ms)]
            if copies:
                ops.append(op("Memcpy DtoD (Device -> Device)", t + 2 * ms,
                              t + 4 * ms, kernel=False))
            t += 4 * ms
    return ops


SNAP = {"calls": 6,
        "spans": {"lif.render_fast_batch": {"n": 6, "total_ms": 90.0,
                                            "self_ms": 6.0},
                  "lif.plan": {"n": 6, "total_ms": 60.0, "self_ms": 30.0},
                  "lif.plan.target": {"n": 2, "total_ms": 20.0,
                                      "self_ms": 20.0},
                  "lif.plan.scaled": {"n": 2, "total_ms": 10.0,
                                      "self_ms": 10.0}},
        "counters": {"route.march": 2, "route.target": 2,
                     "route.scaled": 2}}
WORK = {tier: {"slots": 2, "poses": 288, "planes": 2 * 10**7,
               "pixels": 2 * 10**6, "found": 2 * 10**6,
               "source_texels": 2 * 10**6, "out_px": 2 * 10**6}
        for tier in ("target_march", "scaled_march")}


def ctx(ops, calls=2):
    return SimpleNamespace(
        trace=SimpleNamespace(ops=ops), calls=calls, frames=calls * 432,
        work=WORK, load=parts.load, cell=harness.Cell(ROOT, CELL))


@pytest.fixture
def snap(monkeypatch):
    from lif_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "snapshot", lambda: SNAP)


def read(metric, c):
    return harness.Cell(ROOT, CELL).reader(metric)(c)


def test_readers_values(snap):
    """Plan: the self ms of lif.plan and lif.plan.* a clip; a roofline:
    the tier's least time over its root calls' kernel time (2 ms a
    call)."""
    assert read("renderer.plan_ms_per_call.path", ctx(window())) == (
        pytest.approx(30.0))
    for metric, c in (("target_roofline", parts.load_json(
            ROOT / "benchmark/data/march_costs.json")["target_march"]),
                      ("scaled_roofline", parts.load_json(
            ROOT / "benchmark/data/march_costs.json")["scaled_march"])):
        ops = 2 * 144 * (c["per_plane"] * 10**7 + c["per_pixel"] * 10**6
                         + c["per_found"] * 10**6)
        nbytes = 2 * 10**6 * 20 + 2 * 144 * 10**6 * 16
        least = max(ops / 67e12, nbytes / 3.35e12)
        assert read(metric, ctx(window())) == pytest.approx(
            100 * least / 4e-3)


@pytest.mark.parametrize("case", ["no_copies", "other_kernel", "no_trace",
                                  "other_calls", "no_route"])
def test_rooflines_read_nothing_they_cannot_bear_out(snap, monkeypatch,
                                                     case):
    c = ctx(window())
    if case == "no_copies":
        c = ctx(window(copies=False))
    elif case == "other_kernel":
        c = ctx(window(target_kernel="rotated_march_kernel"))
    elif case == "no_trace":
        c.trace = None
    elif case == "other_calls":
        c.calls = 3
    else:
        monkeypatch.setitem(SNAP, "counters", {"route.march": 2})
    assert read("target_roofline", c) is None
