"""Profiling and metrics: device timers, an FPS counter, trace capture.

The counterpart of lif_tpu.utils.profiling. PyTorch returns before the
device finishes, so a host clock without a synchronize measures the
enqueue; CUDA events time the device stream itself. The reference's only
instrumentation is an FPS HUD with a 500 ms window (reference:
index.html:2181-2204); trace() records a torch.profiler timeline.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from dataclasses import dataclass, field

import torch

__all__ = ["FpsCounter", "benchmark_fn", "device_timer", "trace"]


def device_timer(fn, *args, warmup: int = 1, iters: int = 10, repeats: int = 1,
                 **kwargs) -> float:
    """Milliseconds per call of `fn` on the current CUDA stream.

    Runs `warmup` untimed calls, then `repeats` timed runs of `iters`
    back-to-back calls, each bracketed by CUDA events; returns the median
    over the repeats of (elapsed / iters). Raises without a CUDA device:
    a CPU timing is never a device number."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_timer needs a CUDA device")
    for _ in range(warmup):
        fn(*args, **kwargs)
    torch.cuda.synchronize()
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args, **kwargs)
        end.record()
        torch.cuda.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


@dataclass
class FpsCounter:
    """Windowed frames/sec counter (the HUD metric, 500 ms window).
    reference: index.html:2182-2186."""

    window_seconds: float = 0.5
    _stamps: list = field(default_factory=list)

    def tick(self, now: float | None = None) -> float:
        now = time.perf_counter() if now is None else now
        self._stamps.append(now)
        cutoff = now - self.window_seconds
        self._stamps = [t for t in self._stamps if t >= cutoff]
        if len(self._stamps) < 2:
            return 0.0
        span = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / span if span > 0 else 0.0


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler context over the block: CPU activity, and CUDA
    kernels where torch sees a card; on exit the timeline is written to
    `log_dir`/trace.json (Chrome trace format: chrome://tracing or
    Perfetto). Yields the profiler (key_averages() for sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def benchmark_fn(fn, *args, label: str = "", iters: int = 10,
                 **kwargs) -> dict:
    """device_timer (CUDA events; raises without a card) and a result dict
    {label, seconds_per_call, calls_per_sec}."""
    sec = device_timer(fn, *args, iters=iters, **kwargs) / 1e3
    return {
        "label": label or getattr(fn, "__name__", "fn"),
        "seconds_per_call": sec,
        "calls_per_sec": 1.0 / sec if sec > 0 else float("inf"),
    }
