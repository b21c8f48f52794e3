"""Whole runs on the CPU at a tiny size: the result line, the refusal
without a card, the control and each fault the cells can have, each of
which the check has to find."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import control
from benchmark.lifbench import check, faults, harness

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 101
TINY = {
    "sfmoma.trajectory": {
        "config": {"width": 64, "height": 40},
        "traffic": {"poses_per_call": 8},
        "check": {"sample_frames": 8, "strata": {"slot": 8}}},
    "fusion4k.trajectory": {
        "config": {"width": 96, "height": 56}},
    "sfmoma.view": {
        "config": {"width": 64, "height": 40},
        "check": {"sample_frames": 6, "strata": {"x": [0.0, 0.135, 6]}}},
}
CELLS = sorted(TINY)


def tiny_run(cell, seconds=0.5, trace=False, wrap=None, seed=SEED):
    return harness.run(ROOT, cell, seed, seconds, trace, time.perf_counter(),
                       device="cpu", wrap=wrap, overrides=TINY[cell])


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace):
    res, rows = tiny_run(cell, trace=trace)
    json.dumps(res)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "check" and res["correct"] is True
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert [r[0] for r in rows] == list(res["check"])
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        # no device on the CPU: the readers return nothing, never 0
        assert res["metrics"] == {}
    else:
        cellobj = harness.Cell(ROOT, cell)
        names = {m["name"] for m in cellobj.end_to_end}
        assert set(res["metrics"]) == names - {"peak_mem_GiB"}
        assert all(m["value"] > 0 for m in res["metrics"].values())


def test_no_card_no_result(tmp_path):
    """Without a card the run exits 3 and prints no result; so does a
    checkout that holds only BENCHMARK.json and the benchmark."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this run would measure")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    for where in (ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "sfmoma.trajectory", "--seed", str(SEED), "--seconds", "1",
             "--trace", "0"], cwd=where, capture_output=True, text=True,
            timeout=120)
        assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    """The reference in bfloat16, put in the program's place, fails the
    check while the program passes it."""
    sides = dict(control.readings(ROOT, cell, SEED, 0.3, True, "cpu",
                                  TINY[cell]))
    limits = harness.Cell(ROOT, cell).check["limits"]
    assert check.judge(sides["program"], limits)[0]
    assert not check.judge(sides["control"], limits)[0]


FAULTS = [(c, f) for c in CELLS for f in faults.FAULTS
          if not (f in ("half", "one_slot") and c == "sfmoma.view")]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_fault_is_found(cell, fault):
    res, _ = tiny_run(cell, wrap=faults.FAULTS[fault])
    assert res["correct"] is False, res["check"]


def test_fault_reading_on_the_cpu():
    """control.py's fault reading: the numbers and correct false."""
    numbers, correct = control.fault_reading(
        ROOT, "fusion4k.trajectory", SEED, 0.3, "one_slot", "cpu",
        TINY["fusion4k.trajectory"])
    assert correct is False and numbers["max_gap"] >= 0.2


def offer_calls(reservoir, n, calls, seed):
    rng = np.random.default_rng(seed)
    frames = torch.zeros((n, 1, 1, 4))
    for _ in range(calls):
        x0 = rng.uniform(0.115, 0.155)
        reservoir.offer(frames, {"position": np.stack(
            [x0 + 0.02 * np.arange(n) / n, np.zeros(n), np.zeros(n)], 1)})
    return [s.j for s in reservoir.slots]


@pytest.mark.parametrize("seed", [2**31 + 1, 2**33 + 7, 5])
def test_sample_covers_every_pose_chunk(seed):
    """At the cells' own sizes the sample holds a frame of each 48-pose
    chunk of a 432-pose call and of each camera of the fused rig, on any
    seed."""
    traj = harness.Cell(ROOT, "sfmoma.trajectory").check
    js = offer_calls(check.Reservoir(traj["sample_frames"],
                                     np.random.default_rng(seed),
                                     traj["strata"]), 432, 40, seed)
    assert len(js) == traj["sample_frames"]
    assert {j // 48 for j in js} == set(range(9))
    rig = harness.Cell(ROOT, "fusion4k.trajectory").check
    js = offer_calls(check.Reservoir(rig["sample_frames"],
                                     np.random.default_rng(seed),
                                     rig["strata"]), 4, 40, seed)
    assert sorted(js) == [0, 1, 2, 3]


def test_late_import_gives_no_result(monkeypatch):
    """A module of JAX loaded after the window, by a reader, refuses the
    run as one loaded before it does."""
    import types

    def reader(ctx):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))

    monkeypatch.setattr(harness.Cell, "reader", lambda self, name: reader)
    with pytest.raises(harness.Forbidden):
        tiny_run("sfmoma.view", seconds=0.2)
