"""The stereo cell (sfmoma.stereo) on the CPU at a tiny size (a 64 x 40
view of two 3-layer views outpainted by 16 px, 4 pairs in 2 chunks): the
result line untraced and traced, with the cell's per-layer readers fed a
device activity the CPU lacks; the control and the planted faults; the
configuration against ldi3-1280x800's and the loader's rule; the scene's
right view; the exact stereo march against the program's; and the new
reader on fabricated snapshots."""

import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.lifbench import check, faults, harness, parts, trace, traffic

lt = pytest.importorskip("lif_tpu_torch")
from lif_tpu_torch.utils import profiling  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
CELL = "sfmoma.stereo"
CONFIG = parts.load_json(ROOT / "benchmark/configs/sfmoma-stereo-ldi3.json")
SEED = 2**33 + 2401
W, H, OUTPAINT = 64, 40, 16
N, CHUNK = 8, 4
NEW = ("march_roofline.stereo", "torch_ops.ms_per_frame.stereo",
       "renderer.plan_ms_per_layer.stereo",
       "renderer.host_syncs_per_call.stereo", "device.idle_share.stereo",
       "renderer.stereo_ms_per_blend")


def tiny():
    """The cell's overrides: a 64 x 40 view, 16 px of outpainting, the
    stored ranges under the loader's rule at that width, 2 pose chunks,
    every camera of a call its own stratum of the check."""
    grow = 1.0 + OUTPAINT / W
    return {
        "config": {
            "width": W, "height": H, "outpaint_px": OUTPAINT,
            "layer_width": W + OUTPAINT, "layer_height": H + OUTPAINT,
            "layer_invz": [[near / grow, far / grow] for near, far
                           in CONFIG["assumed"]["layer_invz_stored"]],
            "render_config": dict(CONFIG["render_config"], pose_chunk=CHUNK),
        },
        "traffic": {"poses_per_call": N},
        "check": {"sample_frames": N, "strata": {"slot": N}},
    }


def tiny_run(seconds=0.3, trace_on=False, wrap=None):
    return harness.run(ROOT, CELL, SEED, seconds, trace_on,
                       time.perf_counter(), device="cpu", wrap=wrap,
                       overrides=tiny())


def test_result_line_untraced():
    res, _ = tiny_run()
    assert res["correct"] is True and res["attempted"] % N == 0
    assert set(res["metrics"]) == {"setup_s", "frames_per_s", "psnr_db"}
    assert res["metrics"]["psnr_db"]["value"] > 30.0
    assert set(res["check"]) == {"max_gap", "mean_gap", "mismatch_share"}


def test_result_line_traced(monkeypatch):
    """Traced, the cell reports every new per-layer metric once the
    trace holds device activity (a CPU run has none, so one kernel is
    added to the window read from the profiler); the program counts 6
    planned layers, 6 march routes and 6 blends a call."""
    real = trace.read

    def with_a_kernel(prof):
        tr = real(prof)
        t0 = min(op.start_ns for op in tr.ops) if tr.ops else 0
        tr.ops.append(trace.DeviceOp("lateral_march_kernel", t0, t0 + 10**6,
                                     False))
        tr.busy_s = 1e-3
        return tr

    monkeypatch.setattr(trace, "read", with_a_kernel)
    profiling.reset()  # records an earlier profiled test left behind
    res, _ = tiny_run(trace_on=True)
    assert res["correct"] is True
    assert set(res["metrics"]) == set(NEW)
    for name in NEW:
        assert res["metrics"][name]["value"] is not None
    assert res["metrics"]["renderer.host_syncs_per_call.stereo"]["value"] == 0
    assert res["metrics"]["renderer.stereo_ms_per_blend"]["value"] > 0
    snap = profiling.snapshot()
    calls = snap["calls"]
    assert calls > 0
    for name in ("plan.march_layer", "route.march", "stereo.blend"):
        assert snap["counters"][name] == 6 * calls


def test_traced_on_the_cpu_reads_nothing():
    """Without device activity the readers return nothing, never 0."""
    res, _ = tiny_run(trace_on=True)
    assert res["correct"] is True and res["metrics"] == {}


def test_control_fails():
    """The reference in bfloat16, put in the program's place, fails the
    check while the program passes it."""
    sides = dict(control.readings(ROOT, CELL, SEED, 0.2, True, "cpu",
                                  tiny()))
    limits = harness.Cell(ROOT, CELL).check["limits"]
    assert check.judge(sides["program"], limits)[0]
    assert not check.judge(sides["control"], limits)[0]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_is_found(fault):
    res, _ = tiny_run(wrap=faults.FAULTS[fault])
    assert res["correct"] is False, res["check"]


def test_config_is_two_ldi3_views():
    """Each view is ldi3-1280x800's LDI (sizes, ranges after the loader's
    rule, masks, render configuration), the views at -/+ baseline / 2 on
    x, the stereo discard, nothing cut."""
    ldi3 = parts.load_json(ROOT / "benchmark/configs/ldi3-1280x800.json")
    for key in ("width", "height", "focal_ratio", "baseline_m", "layers",
                "outpaint_px", "layer_width", "layer_height", "layer_invz",
                "mask_cover", "render_config", "precision", "chips"):
        assert CONFIG[key] == ldi3[key], key
    assert (CONFIG["assumed"]["layer_invz_stored"]
            == ldi3["assumed"]["layer_invz_stored"])
    assert CONFIG["view_x_m"] == [-CONFIG["baseline_m"] / 2,
                                  CONFIG["baseline_m"] / 2]
    assert CONFIG["views"] == CONFIG["projectors"] == 2
    assert CONFIG["mask_mode"] == "hard"
    manifest = parts.load_json(ROOT / "BENCHMARK.json")
    entry = next(c for c in manifest["configs"]
                 if c["name"] == CONFIG["name"])
    assert entry["reduced"] == [] and len(entry["source"]) <= 200


def test_traffic_keeps_every_eye_in_the_ldi_range():
    """Every eye lies within +-0.055 m and at most 0.0775 m from either
    view, inside the +-0.09 m the LDI cell renders; 48 pairs a call."""
    mix = parts.data("traffic", "stereo-sway-48")
    path = mix["path"]
    assert mix["poses_per_call"] == 96
    (lo, hi), eye = path["origin"][0], path["eye_m"]
    far = max(abs(lo - eye), abs(hi + path["span"][0] + eye))
    assert far == pytest.approx(0.055)
    assert far + CONFIG["baseline_m"] / 2 == pytest.approx(0.0775)
    ldi = parts.data("traffic", "ldi-sway-192")["path"]
    assert far + CONFIG["baseline_m"] / 2 <= max(
        abs(ldi["origin"][0][0]), ldi["origin"][0][1] + ldi["span"][0])


@pytest.fixture(scope="module")
def scene():
    cell = harness.Cell(ROOT, CELL, tiny())
    part = parts.load("scenes", cell.config["scene"])
    srcs = part.build(cell.config, SEED, torch.device("cpu"))
    return cell, srcs, part.projectors(lt, srcs, cell.config)


def test_right_view_is_the_left_re_marched(scene):
    """Two views at the configured x; the right layers 8-bit, each mask 0
    where the left layer shows nothing there and about the left's cover;
    the bottom right layer covers nearly all of its texels."""
    cell, (left, right), projs = scene
    assert [float(p.position[0]) for p in projs] == pytest.approx(
        cell.config["view_x_m"])
    for lay_l, lay_r, cover in zip(left, right, cell.config["mask_cover"]):
        for t in (lay_r.disp, lay_r.mask):
            assert torch.equal(torch.round(t * 255) / 255, t)
        assert lay_r.izmin == lay_l.izmin and lay_r.x > lay_l.x
        assert abs(float(lay_r.mask.mean()) - cover) < 0.1
    assert float((right[-1].mask == 1).float().mean()) > 0.9


@pytest.mark.parametrize("x", [-0.05, 0.0, 0.04])
def test_exact_stereo_follows_the_program_exact_march(scene, x):
    """The exact stereo march agrees with the program's
    render_stereo_view (the two-view march, dilated discard, confidence
    fill and blend) on the same views."""
    cell, srcs, projs = scene
    poses = {"position": np.array([[x, 0.0, 0.0]])}
    ours = parts.load("reference", "exact_stereo_ldi").render_slot(
        srcs, check.Slot(None, 0, poses), cell.config)
    cam = traffic.cameras(lt, poses, cell.config)[0]
    theirs = lt.render_stereo_view(*projs, cam, num_steps=640)
    gap = (ours - theirs).abs()
    # the same march; the float32 transforms differ in the last bit
    assert float(gap.mean()) < 1e-4
    assert float((gap > 1e-3).float().mean()) < 0.01


SNAP = {"calls": 4,
        "spans": {"lif.render_stereo_fast_batch": {"n": 4, "total_ms": 90.0,
                                                   "self_ms": 6.0},
                  "lif.plan": {"n": 4, "total_ms": 20.0, "self_ms": 12.0},
                  "lif.stereo.conf": {"n": 48, "total_ms": 30.0,
                                      "self_ms": 30.0},
                  "lif.stereo.blend": {"n": 24, "total_ms": 18.0,
                                       "self_ms": 18.0}},
        "counters": {"plan.march_layer": 24, "route.march": 24,
                     "stereo.blend": 24, "sync.upload.poses": 96}}


def ctx(calls=4, ops=(object(),)):
    return SimpleNamespace(trace=SimpleNamespace(ops=list(ops)), calls=calls,
                           load=parts.load)


def test_stereo_ms_per_blend_reads_the_counter(monkeypatch):
    """The lif.stereo.* self ms over the blends: (30 + 18) / 24; None
    without the counter (a program that has none), without device
    activity, or where the root calls are not the window's."""
    read = harness.Cell(ROOT, CELL).reader("renderer.stereo_ms_per_blend")
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAP)
    assert read(ctx()) == pytest.approx(2.0)
    assert read(ctx(ops=())) is None
    assert read(ctx(calls=5)) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: dict(
        SNAP, counters={"route.march": 24}))
    assert read(ctx()) is None


def test_split_names_find_their_readers():
    """Every per-layer metric of the cell has a reader: its own file or
    the quantity's."""
    cell = harness.Cell(ROOT, CELL)
    assert {m["name"] for m in cell.per_layer} == set(NEW)
    for name in NEW:
        assert parts.exists("metrics", cell.reader_name(name))
