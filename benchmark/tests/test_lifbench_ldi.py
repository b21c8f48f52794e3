"""The LDI cell (ldi3-1280x800.trajectory) on the CPU at a tiny size (a
64 x 40 view of 3 layers outpainted by 16 px, 8 poses in 2 chunks): the
result line untraced and traced, with the cell's per-layer readers fed a
device activity the CPU lacks; the control and the planted faults; the
configuration against the loader's rule; the scene's layers; the exact
march against the program's; and the new reader on fabricated
snapshots."""

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
CELL = "ldi3-1280x800.trajectory"
CONFIG = parts.load_json(ROOT / "benchmark/configs/ldi3-1280x800.json")
SEED = 2**33 + 2203
W, H, OUTPAINT = 64, 40, 16
N, CHUNK = 8, 4
NEW = ("march_roofline.ldi", "renderer.plan_ms_per_layer.ldi",
       "renderer.host_syncs_per_call.ldi", "device.idle_share.ldi")


def tiny():
    """The cell's overrides: a 64 x 40 view, 16 px of outpainting, the
    stored ranges under the loader's rule at that width, 2 pose chunks."""
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
        "check": {"sample_frames": 8, "strata": {"slot": 8}},
    }


def tiny_run(seconds=0.4, trace_on=False, wrap=None):
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
    added to the window read from the profiler); the program counts 3
    planned layers a call and 2 behind-layer epilogues a chunk."""
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
    assert res["metrics"]["renderer.host_syncs_per_call.ldi"]["value"] == 0
    assert res["metrics"]["renderer.plan_ms_per_layer.ldi"]["value"] > 0
    snap = profiling.snapshot()
    calls = snap["calls"]
    assert calls > 0
    assert snap["counters"]["plan.march_layer"] == 3 * calls
    assert snap["counters"]["epilogue.lateral.behind"] == 2 * 2 * calls
    assert snap["counters"]["route.march"] == 3 * calls


def test_traced_on_the_cpu_reads_nothing():
    """Without device activity the readers return nothing, never 0."""
    res, _ = tiny_run(trace_on=True)
    assert res["correct"] is True and res["metrics"] == {}


def test_control_fails():
    """The reference in bfloat16, put in the program's place, fails the
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


def test_config_follows_the_loader_rule():
    """The configuration's ranges are the stored ones divided by 1 +
    outpaint / width, each layer the view plus the outpainting, at the
    view's focal, mask mode 'multiply', nothing cut."""
    grow = 1.0 + CONFIG["outpaint_px"] / CONFIG["width"]
    assert grow == pytest.approx(1.1)
    np.testing.assert_allclose(
        CONFIG["layer_invz"],
        np.array(CONFIG["assumed"]["layer_invz_stored"]) / grow, rtol=1e-15)
    assert (CONFIG["layer_width"], CONFIG["layer_height"]) == (1408, 928)
    assert (CONFIG["width"], CONFIG["height"]) == (1280, 800)
    assert CONFIG["layers"] == len(CONFIG["layer_invz"]) == 3
    assert CONFIG["mask_mode"] == "multiply"
    manifest = parts.load_json(ROOT / "BENCHMARK.json")
    entry = next(c for c in manifest["configs"]
                 if c["name"] == CONFIG["name"])
    assert entry["reduced"] == []
    rc = CONFIG["render_config"]
    assert rc["pose_chunk"] == lt.RenderConfig().pose_chunk == 48
    sfmoma = parts.load_json(ROOT / "benchmark/configs/sfmoma-1280x800.json")
    assert {k: rc[k] for k in sfmoma["render_config"]} == \
        sfmoma["render_config"]


@pytest.fixture(scope="module")
def layers():
    """The scene's layers at a third of the cell's size."""
    cfg = {**CONFIG, "width": 432, "height": 264, "layer_width": 560,
           "layer_height": 392}
    return parts.load("scenes", "ldi-layers").build(cfg, SEED,
                                                    torch.device("cpu"))


@pytest.mark.parametrize("i,lo,hi", [(0, 0.2, 0.4), (1, 0.4, 0.7),
                                     (2, 1.0, 1.0)], ids=["top", "middle",
                                                          "bottom"])
def test_scene_layers(layers, i, lo, hi):
    """8-bit disparity and mask; the mask covers its share of the layer
    (the bottom one all of it); a masked layer's edges hold values
    strictly between 0 and 1, at least 2 texels wide along a row."""
    layer = layers[i]
    for t in (layer.disp, layer.mask):
        assert torch.equal(torch.round(t * 255) / 255, t)
    assert 0.1 <= float(layer.disp.min()) and float(layer.disp.max()) <= 0.9
    m = layer.mask
    assert lo <= float(m.mean()) <= hi
    assert lo <= float((m > 0).float().mean()) <= hi
    if hi == 1.0:
        assert bool((m == 1).all())
        return
    partial = (m > 0) & (m < 1)
    assert float(partial.float().mean()) > 0.02
    # no row steps from 0 to 1, or from 1 to 0, in fewer than 2 texels
    step = m[:, 1:] - m[:, :-1]
    assert float(step.abs().max()) < 1.0
    two = m[:, 2:] - m[:, :-2]
    assert not bool(((two.abs() == 1.0)).any())


@pytest.mark.parametrize("x", [-0.07, 0.0, 0.05])
def test_exact_ldi_follows_the_program_exact_march(x):
    """The exact LDI march agrees with the program's render_mono_view on
    the same outpainted, masked layers."""
    cell = harness.Cell(ROOT, CELL, tiny())
    scene = parts.load("scenes", "ldi-layers")
    srcs = scene.build(cell.config, SEED, torch.device("cpu"))
    (proj,) = scene.projectors(lt, srcs, cell.config)
    poses = {"position": np.array([[x, 0.0, 0.0]])}
    ours = parts.load("reference", "exact_ldi").render_slot(
        srcs, check.Slot(None, 0, poses), cell.config)
    cam = traffic.cameras(lt, poses, cell.config)[0]
    theirs = lt.render_mono_view(proj, cam, num_steps=640)
    gap = (ours - theirs).abs()
    # the same march; the float32 transforms differ in the last bit
    assert float(gap.mean()) < 1e-4
    assert float((gap > 1e-3).float().mean()) < 0.01


SNAP = {"calls": 4,
        "spans": {"lif.render_fast_batch": {"n": 4, "total_ms": 90.0,
                                            "self_ms": 6.0},
                  "lif.plan": {"n": 8, "total_ms": 60.0, "self_ms": 48.0}},
        "counters": {"plan.march_layer": 12, "route.march": 12,
                     "sync.upload.poses": 16}}


def ctx(calls=4, ops=(object(),)):
    return SimpleNamespace(trace=SimpleNamespace(ops=list(ops)), calls=calls,
                           load=parts.load)


def test_plan_ms_per_layer_reads_the_counter(monkeypatch):
    """lif.plan's self ms over the march layers planned: 48 / 12; None
    without the counter (a program that has none), without device
    activity, or where the root calls are not the window's."""
    read = harness.Cell(ROOT, CELL).reader("renderer.plan_ms_per_layer.ldi")
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAP)
    assert read(ctx()) == pytest.approx(4.0)
    assert read(ctx(ops=())) is None
    assert read(ctx(calls=5)) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: dict(
        SNAP, counters={"route.march": 12}))
    assert read(ctx()) is None
