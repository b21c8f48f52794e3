"""The readers of the program's spans and counters,
renderer.plan_ms_per_call and renderer.host_syncs_per_call, on a
fabricated run and snapshot: their values, each case in which they read
nothing, and a real snapshot of the program under a CPU profiler."""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark.lifbench import harness, parts
from lif_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[2]
PLAN = "renderer.plan_ms_per_call"
SYNCS = "renderer.host_syncs_per_call"
SNAP = {
    "calls": 4,
    "spans": {"lif.render_fast_batch": {"n": 4, "total_ms": 400.0,
                                        "self_ms": 8.0},
              "lif.plan": {"n": 8, "total_ms": 380.0, "self_ms": 372.0},
              "lif.prep": {"n": 4, "total_ms": 8.0, "self_ms": 8.0}},
    "counters": {"sync.upload.poses": 72, "sync.upload.background": 72,
                 "sync.upload.plane_table": 4, "cache.table.miss": 4,
                 "cache.texture.hit": 4},
}


def ctx(calls=4, ops=(object(),), traced=True):
    trace = SimpleNamespace(ops=list(ops)) if traced else None
    return SimpleNamespace(trace=trace, calls=calls, load=parts.load)


def read(metric, c):
    return parts.load("metrics", metric).read(c)


@pytest.fixture
def snap(monkeypatch):
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAP)


def test_values(snap):
    """Plan: the self ms of lif.plan a root call; syncs: the sum of the
    sync.* counters a root call (cache counters left out)."""
    assert read(PLAN, ctx()) == pytest.approx(93.0)
    assert read(SYNCS, ctx()) == pytest.approx(37.0)


@pytest.mark.parametrize("metric", [PLAN, SYNCS])
@pytest.mark.parametrize("case", ["untraced", "no_device", "other_calls"])
def test_nothing_to_read(snap, metric, case):
    """None without a trace, with a trace of no device activity (a CPU
    run), and where the snapshot's root calls are not the window's."""
    c = {"untraced": ctx(traced=False), "no_device": ctx(ops=()),
         "other_calls": ctx(calls=5)}[case]
    assert read(metric, c) is None


@pytest.mark.parametrize("metric", [PLAN, SYNCS])
def test_program_without_snapshot(monkeypatch, metric):
    """A program that records no spans (one without
    profiling.snapshot) reads None, and raises nothing."""
    monkeypatch.delattr(profiling, "snapshot")
    assert read(metric, ctx()) is None


def test_no_plan_span(monkeypatch):
    """A snapshot without a lif.plan span gives no plan reading."""
    monkeypatch.setattr(profiling, "snapshot", lambda: dict(
        SNAP, spans={"lif.render_fast_view": SNAP["spans"]["lif.plan"]}))
    assert read(PLAN, ctx()) is None
    assert read(SYNCS, ctx()) == pytest.approx(37.0)


@pytest.mark.parametrize("split", ["batch", "view"])
def test_split_names_fall_back(split):
    """The cells' split names are served by the quantity's reader."""
    for metric in (PLAN, SYNCS):
        assert harness.Cell.reader_name(f"{metric}.{split}") == metric


def test_reads_the_program():
    """The program's own snapshot of two CPU calls: two root calls, a
    positive plan time, no host sync on the CPU."""
    import lif_tpu_torch as lt

    h, w = 16, 32
    rng = np.random.default_rng(0)
    proj = lt.projector_from_arrays(
        rng.random((h, w, 3)).astype(np.float32),
        rng.random((h, w)).astype(np.float32), focal_px=0.78 * w,
        invz_min=2.0, invz_max=0.1, baseline=1.0, device="cpu")
    cams = [lt.Camera.create(w, h, focal_px=0.78 * w,
                             position=[0.01 * (i + 1), 0.0, 0.0])
            for i in range(3)]
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            lt.render_fast_batch(proj, cams)
    assert read(PLAN, ctx(calls=2)) > 0.0
    assert read(SYNCS, ctx(calls=2)) == 0.0
    assert read(PLAN, ctx(calls=3)) is None
