"""The renderer's spans and counters (lif_tpu_torch.utils.profiling), on
the CPU at 32x64.

With no profiler running nothing records, and no record_function range
is even made; under torch.profiler.profile each public fast entry point
is one root call however it recurses, every span carries its root's call
id and shows in the profiler's own events, self time never exceeds total
time, a replayed pose batch hits the snap-table cache, a CPU run counts
no host sync, and trace() resets the records and writes them to
spans.json.
"""

import json

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import lif_tpu_torch as lt
from lif_tpu_torch.models import renderer
from lif_tpu_torch.utils import profiling

H, W = 32, 64
FOCAL = 0.78 * W


def _projector(rng, **kw):
    disp = (0.3 + 0.4 * rng.random((H, W))).astype(np.float32)
    disp[H // 4:H // 2, W // 4:W // 2] = 0.9
    rgb = rng.random((H, W, 3)).astype(np.float32)
    return lt.projector_from_arrays(rgb, disp, focal_px=FOCAL, invz_min=2.0,
                                    invz_max=0.1, baseline=1.0, device="cpu",
                                    **kw)


def _cams(xs, y=0.0):
    return [lt.Camera.create(W, H, focal_px=FOCAL, position=[x, y, 0.0])
            for x in xs]


# small pose chunks: the 5-pose batches render in 3 chunks
CFG = lt.DEFAULT_CONFIG.replace(pose_chunk=2)


def _calls(rng):
    """name -> (a call of the entry point, the spans it must record)."""
    proj = _projector(rng)
    other = _projector(rng, position=(0.02, 0.0, 0.0))
    xs = [0.011, 0.013, 0.017, 0.019, 0.023]
    return {
        "batch": (lambda: lt.render_fast_batch(proj, _cams(xs), config=CFG),
                  {"lif.render_fast_batch", "lif.plan", "lif.prep",
                   "lif.chunk", "lif.composite"}),
        "view": (lambda: lt.render_fast_view(proj, _cams([0.021])[0]),
                 {"lif.render_fast_view", "lif.plan", "lif.chunk",
                  "lif.composite"}),
        # a y-only pose: render_fast_view calls itself on the transpose
        "view_transposed": (
            lambda: lt.render_fast_view(proj, _cams([0.0], y=0.015)[0]),
            {"lif.render_fast_view", "lif.plan", "lif.chunk"}),
        # a dolly: render_fast_view calls render_fast_batch
        "view_dolly": (
            lambda: lt.render_fast_view(proj, lt.Camera.create(
                W, H, focal_px=FOCAL, position=[0.0, 0.0, 0.02])),
            {"lif.render_fast_view", "lif.render_fast_batch", "lif.plan"}),
        "fused": (lambda: lt.render_fused_fast_batch([proj, other],
                                                     _cams(xs), config=CFG),
                  {"lif.render_fused_fast_batch", "lif.plan", "lif.chunk",
                   "lif.merge", "lif.composite"}),
        "stereo": (lambda: lt.render_stereo_fast_batch(proj, other,
                                                       _cams(xs[:2])),
                   {"lif.render_stereo_fast_batch", "lif.plan", "lif.chunk",
                    "lif.stereo.conf", "lif.stereo.blend",
                    "lif.composite"}),
        "billboard": (lambda: lt.render_billboard_fast_batch(proj,
                                                             _cams(xs[:2])),
                      {"lif.render_billboard_fast_batch", "lif.plan",
                       "lif.kernel.billboard", "lif.inputs",
                       "lif.epilogue.billboard"}),
    }


def _traced(fn, calls=2):
    """Runs fn `calls` times under a CPU profiler from reset records;
    returns the profiler."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(calls):
            fn()
    return prof


def test_off_records_nothing_and_makes_no_range(rng, monkeypatch):
    """No profiler: a 3-chunk render_fast_batch, render_fast_view and
    render_fused_fast_batch leave no record and no counter, and never
    reach torch.profiler.record_function."""
    calls = _calls(rng)
    profiling.reset()

    def refuse(*args, **kwargs):
        raise AssertionError("record_function made with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    for name in ("batch", "view", "fused"):
        calls[name][0]()
    assert profiling.snapshot() == {"calls": 0, "spans": {}, "counters": {}}
    assert profiling.records() == []


@pytest.mark.parametrize("name", ["batch", "view", "view_transposed",
                                  "view_dolly", "fused", "stereo",
                                  "billboard"])
def test_one_root_per_call(rng, name):
    """Two calls of an entry point are two root calls, however it
    recurses; every span carries its root's call id; the named spans are
    in the profiler's events on its clock; self time <= total time."""
    fn, names = _calls(rng)[name]
    prof = _traced(fn)
    snap = profiling.snapshot()
    assert snap["calls"] == 2
    recs = profiling.records()
    roots = [i for i, r in enumerate(recs) if r["parent"] is None]
    assert [recs[i]["call"] for i in roots] == [1, 2]
    for r in recs:
        assert r["end_ns"] >= r["start_ns"]
        root = r
        while root["parent"] is not None:
            root = recs[root["parent"]]
        assert r["call"] == root["call"]
    assert names <= set(snap["spans"])
    events = {e.name() for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CPU}
    assert names <= events
    for s in snap["spans"].values():
        assert 0.0 <= s["self_ms"] <= s["total_ms"] + 1e-9


def test_self_time_leaves_out_child_spans():
    """A span's self time is its duration less its children's, and
    nested spans outside any entry point open no call."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer"):
            with profiling.span("inner"):
                torch.ones(8).sum()
            with profiling.span("inner"):
                torch.ones(8).sum()
    snap = profiling.snapshot()
    assert snap["calls"] == 0
    outer, inner = snap["spans"]["outer"], snap["spans"]["inner"]
    assert inner["n"] == 2 and outer["n"] == 1
    assert outer["self_ms"] == pytest.approx(
        outer["total_ms"] - inner["total_ms"], abs=1e-6)
    assert inner["self_ms"] == pytest.approx(inner["total_ms"], abs=1e-9)
    assert [r["parent"] for r in profiling.records()] == [None, 0, 0]


def test_replayed_batch_hits_the_table_cache(rng):
    """The first call of a fresh pose batch misses the snap-table cache,
    an identical second call hits it (and the texture cache)."""
    proj = _projector(rng)
    cams = _cams([0.0311, 0.0313, 0.0317])
    renderer._TABLE_CACHE.clear()
    _traced(lambda: lt.render_fast_batch(proj, cams), calls=1)
    first = profiling.snapshot()["counters"]
    assert first.get("cache.table.miss") == 1
    assert "cache.table.hit" not in first
    _traced(lambda: lt.render_fast_batch(proj, cams), calls=1)
    second = profiling.snapshot()["counters"]
    assert second.get("cache.table.hit") == 1
    assert "cache.table.miss" not in second
    assert second.get("cache.texture.hit", 0) >= 1


@pytest.mark.parametrize("name", ["batch", "fused", "stereo", "billboard"])
def test_no_host_sync_on_the_cpu(rng, name):
    """sync.* counts only where a tensor is on CUDA: a CPU run counts
    none, while the cache counters do count."""
    fn, _ = _calls(rng)[name]
    _traced(fn)
    counters = profiling.snapshot()["counters"]
    assert not [k for k in counters if k.startswith("sync.")]
    assert any(k.startswith("cache.") for k in counters)


def test_lru_get_counts_hits_and_misses():
    """_lru_get: a hit moves the entry to the LRU end, a rejected entry
    is a miss and stays where it was."""
    from collections import OrderedDict

    cache = OrderedDict([("a", 1), ("b", 2)])
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        assert renderer._lru_get(cache, "a", "table") == 1
        assert renderer._lru_get(cache, "c", "table") is None
        assert renderer._lru_get(cache, "b", "table",
                                 valid=lambda e: e > 5) is None
    assert list(cache) == ["b", "a"]
    assert profiling.snapshot()["counters"] == {"cache.table.hit": 1,
                                                "cache.table.miss": 2}


def test_trace_writes_spans_and_resets(rng, tmp_path):
    """trace() resets the records on entry (a call profiled before it is
    gone) and writes spans.json beside trace.json: the records and the
    snapshot of the traced block's one call."""
    fn, _ = _calls(rng)["batch"]
    _traced(fn)
    with profiling.trace(str(tmp_path / "prof")):
        fn()
    doc = json.loads((tmp_path / "prof" / "spans.json").read_text())
    assert (tmp_path / "prof" / "trace.json").is_file()
    assert doc["snapshot"]["calls"] == 1
    assert doc["snapshot"] == json.loads(json.dumps(profiling.snapshot()))
    assert doc["records"][0]["name"] == "lif.render_fast_batch"
    assert {r["call"] for r in doc["records"]} == {1}
