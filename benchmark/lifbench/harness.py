"""One run of one cell: set-up, the measured window, the output check and
the result line.

Everything a cell needs is found by name (lifbench.parts): the cell in
BENCHMARK.json; its configuration's file, which names its scene under
scenes/; its traffic mix under traffic/, which names its pose path under
paths/, its entry point under entries/ and its loop under loops/; its
check under checks/<cell>.json, which names its reference under
reference/; and each metric's reader under metrics/. Nothing here names
a cell, an entry point, a tier or a kernel.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import check, parts, trace, traffic

PROGRAM = "lif_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "lif_tpu")


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


class Forbidden(RuntimeError):
    """A module of JAX or of the JAX package was loaded in the run."""


class Cell:
    """A cell of the manifest with its configuration, traffic, check and
    metrics, read from their files."""

    def __init__(self, root: Path, name: str, overrides: dict | None = None):
        m = parts.load_json(Path(root) / "BENCHMARK.json")
        cells = {w["name"]: w for w in m["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name, self.spec = name, cells[name]
        cfg = {c["name"]: c for c in m["configs"]}[self.spec["config"]]
        self.config = parts.load_json(Path(root) / cfg["file"])
        self.traffic = parts.data("traffic", self.spec["traffic"])
        self.check = parts.data("checks", name)
        # tests shrink a cell: {"config": {...}, "traffic": {...}, ...}
        for part, changes in (overrides or {}).items():
            setattr(self, part, {**getattr(self, part), **changes})
        self.end_to_end = [x for x in m["end_to_end"]
                           if name in x.get("workloads", [name])]
        e2e = {x["name"] for x in self.end_to_end}
        self.per_layer = [x for x in m["per_layer"]
                          if name in x.get("workloads", [name])
                          and x["moves"] in e2e]

    @staticmethod
    def reader_name(metric: str) -> str:
        """The reader file of a metric: metrics/<metric>.py, else that of
        the metric with its last dotted part dropped, and so on (one
        reader serves a quantity split by cells)."""
        name = metric
        while not parts.exists("metrics", name) and "." in name:
            name = name.rsplit(".", 1)[0]
        return name

    def reader(self, metric: str):
        return parts.load("metrics", self.reader_name(metric)).read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's, compared whole."""
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def refuse_forbidden():
    found = forbidden_modules()
    if found:
        raise Forbidden("loaded in the run's process: " + ", ".join(found))


def resolve_device(chips: int, device=None) -> torch.device:
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise NoDevice("torch sees no CUDA device")
    if torch.cuda.device_count() < chips:
        raise NoDevice(f"the cell asks for {chips} cards, torch sees "
                       f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def rngs(seed: int):
    """Independent numpy generators of the window's poses, the warm-up's
    poses and the output sample, from the seed."""
    s = int(seed) % 2**64
    return [np.random.default_rng([s, k]) for k in (1, 2, 3)]


class Session:
    """The program set up for one cell and seed: the scene's sources (the
    reference's inputs), the program's projectors made from them, and the
    entry call the window drives."""

    def __init__(self, cell: Cell, seed: int, device, wrap=None):
        lt = importlib.import_module(PROGRAM)
        self.cell, self.device = cell, device
        self.cuda = device.type == "cuda"
        scene = parts.load("scenes", cell.config["scene"])
        self.srcs = scene.build(cell.config, seed, device)
        entry = parts.load("entries", cell.traffic["entry"]).make(
            lt, scene.projectors(lt, self.srcs, cell.config),
            cell.config["render_config"],
            dict(cell.traffic.get("entry_kwargs", {})))
        self.loop = parts.load("loops", cell.traffic["loop"])
        self.pose_rng, warm_rng, self.sample_rng = rngs(seed)
        self.warm_stream = traffic.PoseStream(cell.traffic, warm_rng)

        def call(poses):
            return entry(traffic.cameras(lt, poses, cell.config))

        self.call = wrap(call) if wrap else call

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def warm(self, calls: int = 2):
        for _ in range(calls):
            self.call(self.warm_stream.next())
            self.sync()

    def sampler(self) -> check.Reservoir:
        return check.Reservoir(self.cell.check["sample_frames"],
                               self.sample_rng, self.cell.check.get("strata"))

    def window(self, seconds: float, sampler, profile: bool = False):
        """The cell's loop for `seconds`. Returns (t0, records of (due,
        start, end, frames)) and, when profiled, the trace."""
        stream = traffic.PoseStream(self.cell.traffic, self.pose_rng)
        prof = None
        if profile:
            from torch.profiler import ProfilerActivity, profile as tp

            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            prof = tp(activities=acts)
            prof.__enter__()
        span = (lambda: torch.profiler.record_function(trace.CALL_SPAN)
                ) if profile else contextlib.nullcontext
        try:
            t0, records = self.loop.run(self.call, stream, seconds, self.sync,
                                        sampler.offer, span)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
        return t0, records, (trace.read(prof) if prof is not None else None)

    def release(self):
        """Frees the program's state: its projectors and entry call."""
        self.call = None
        if self.cuda:
            torch.cuda.empty_cache()

    def compare(self, slots, dtype=torch.float32):
        """(frame, reference) pairs of the sampled slots, and the work of
        the reference's marches, summed by tier with the slots counted."""
        ref = parts.load("reference", self.cell.check["reference"])
        options = self.cell.check.get("options", {})
        pairs, work = [], {}
        for slot in slots:
            frame, counts = ref.render_slot(self.srcs, slot, self.cell.config,
                                            options, dtype)
            pairs.append((slot.frame, frame))
            for tier, c in counts.items():
                acc = work.setdefault(tier, {"slots": 0})
                acc["slots"] += 1
                for k, v in c.items():
                    acc[k] = acc.get(k, 0) + v
        return pairs, work


def run(root, workload: str, seed: int, seconds: float, trace_on: bool,
        t_start: float, device=None, wrap=None, overrides=None):
    """One run; returns (result dict, the compared rows). device, wrap
    (a fault planted around the entry call) and overrides are for tests
    and for reading a fault on the card."""
    cell = Cell(root, workload, overrides)
    dev = resolve_device(cell.spec["chips"], device)
    sess = Session(cell, seed, dev, wrap)
    sess.warm()
    setup_peak = window_peak = None
    if sess.cuda:
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    sample = sess.sampler()
    setup_s = time.perf_counter() - t_start
    seconds_w = seconds
    if trace_on and cell.traffic.get("trace_seconds"):
        seconds_w = min(seconds, cell.traffic["trace_seconds"])
    t0, records, tr = sess.window(seconds_w, sample, profile=trace_on)
    frames = sum(r[3] for r in records)
    print(f"window: {len(records)} calls, {frames} frames, "
          f"{records[-1][2] - t0:.3f} s, "
          f"{sum(r[2] - r[1] for r in records):.3f} s inside calls",
          file=sys.stderr)
    if sess.cuda:
        window_peak = torch.cuda.max_memory_allocated(dev)
    refuse_forbidden()
    sess.release()

    pairs, work = sess.compare(sample.slots)
    correct, rows = check.judge(check.gaps(pairs), cell.check["limits"])
    del pairs

    ctx = SimpleNamespace(
        cell=cell, setup_s=setup_s, t0=t0, records=records, frames=frames,
        calls=len(records), window_peak=window_peak, trace=tr, work=work,
        slots=sample.slots, srcs=sess.srcs, load=parts.load)
    metrics = {}
    for m in (cell.per_layer if trace_on else cell.end_to_end):
        v = cell.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # the check, the references and the readers have run: once more
    refuse_forbidden()

    result = {
        "correct": bool(correct),
        "attempted": frames,
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if sess.cuda else dev.type,
            "kind": (torch.cuda.get_device_name(dev) if sess.cuda
                     else dev.type),
            "count": cell.spec["chips"],
            "memory_peak_bytes": int(max(setup_peak, window_peak)
                                     if sess.cuda else 0),
        },
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows
