"""Profiling: device timers, trace capture, and the renderer's spans and
counters.

The counterpart of lif_tpu.utils.profiling. PyTorch returns before the
device finishes, so a host clock without a synchronize measures the
enqueue; CUDA events time the device stream itself (device_timer).
trace() records a torch.profiler timeline.

Spans and counters record exactly while a torch profiler records in this
process (torch.profiler.profile, trace() below, the benchmark's traced
window); otherwise span(), entry's wrapper, count() and host_sync() read
the profiler's flag once and do nothing else (span returns a shared
no-op). A span is a torch.profiler.record_function range, so it sits on
the profiler's clock beside the device activity it launches (its
device-side annotation groups those kernels), plus an in-memory record:
name, parent span, the call it belongs to and host start/end in ns. The
outermost entry point of a call (entry) is a root span and opens a call;
every span inside carries that call's id. Names are constant strings
("lif.plan", "lif.kernel.lateral", ...; PERF.md lists them), so a trace's
idle gaps sum by name. Counters count where the work happens: "sync.*"
each point where the host waits for a CUDA stream (host_sync),
"cache.<name>.hit" / ".miss" the renderer's caches, "route.<tier>" the
tier each layer of a render_fast_batch call (and each eye-layer of a
render_stereo_fast_batch call) renders on, "stereo.blend" each layer of a
stereo pose chunk blended across both eyes (its work in the
"lif.stereo.conf" and "lif.stereo.blend" spans), "plan.march_layer"
each layer planned on the lateral march, "epilogue.<tier>.fused" each
launch of a tier's epilogue kernel, "epilogue.lateral.behind" each
such lateral launch behind an LDI's front layer and "epilogue.fused.merge"
each launch of the fused epilogue kernel (render_fused_fast_batch, a
pose chunk, in the "lif.epilogue.fused" span; on the CPU each call of its
plain version). snapshot() sums the
records; reset() clears them; trace() resets on entry and writes them
beside the timeline.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import statistics
import threading
import time

import torch

__all__ = ["count", "device_timer", "entry", "host_sync", "records",
           "reset", "snapshot", "span", "trace"]

# True while a torch profiler records in this process (kineto's own flag)
_recording = torch._C._autograd._profiler_enabled

# the records: spans as [name, parent index, call id, start ns, end ns],
# counters by name, and each thread's stack of open span indices
_spans: list = []
_counters: dict = {}
_calls = [0]
_local = threading.local()


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


class _Off:
    """The span while no profiler records: enters and exits, nothing more."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return None


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """A recording span: a record_function range and its record."""

    __slots__ = ("_name", "_root", "_range", "_rec", "_index")

    def __init__(self, name: str, root: bool = False):
        self._name, self._root = name, root

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        if parent is not None and parent < len(_spans):
            call = _spans[parent][2]
        elif self._root:
            parent = None
            _calls[0] += 1
            call = _calls[0]
        else:
            parent = call = None
        self._range = torch.profiler.record_function(self._name)
        self._range.__enter__()
        self._index = len(_spans)
        self._rec = [self._name, parent, call, time.perf_counter_ns(), None]
        _spans.append(self._rec)
        stack.append(self._index)
        return None

    def __exit__(self, *exc):
        self._rec[4] = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] == self._index:
            stack.pop()
        self._range.__exit__(*exc)
        return None


def span(name: str):
    """Context manager: the span `name` while a profiler records, else a
    shared no-op."""
    if not _recording():
        return _OFF
    return _Span(name)


def entry(fn):
    """Decorator of a public entry point: its call is the span
    "lif.<function name>", a root that opens a call where no span is
    open (an entry called from inside another is a child span of it)."""
    name = "lif." + fn.__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _recording():
            return fn(*args, **kwargs)
        with _Span(name, root=True):
            return fn(*args, **kwargs)

    return wrapper


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter `name` while a profiler records."""
    if _recording():
        _counters[name] = _counters.get(name, 0) + n


def host_sync(name: str, device, n: int = 1) -> None:
    """Counts n host waits on the stream at the site `name` ("sync.*"):
    pageable host-to-device uploads, readbacks or explicit synchronizes,
    where `device` (a torch.device) is a CUDA device; a CPU run counts
    none."""
    if _recording() and device.type == "cuda":
        _counters[name] = _counters.get(name, 0) + n


def reset() -> None:
    """Clears every span record and counter (call outside any span)."""
    _spans.clear()
    _counters.clear()
    _calls[0] = 0
    _local.stack = []


def records() -> list:
    """The span records in the order they opened, as dicts: name, parent
    (an index into this list, or None), call (the root's call id, or None
    outside a call), start_ns and end_ns (host perf_counter_ns; None while
    the span is open)."""
    return [dict(name=n, parent=p, call=c, start_ns=t0, end_ns=t1)
            for n, p, c, t0, t1 in _spans]


def snapshot() -> dict:
    """{"calls": root calls, "spans": {name: {"n", "total_ms",
    "self_ms"}}, "counters": {name: n}} over the closed spans. A span's
    self time is its duration less what its child spans cover."""
    child = [0] * len(_spans)
    for _, parent, _, t0, t1 in _spans:
        if t1 is not None and parent is not None:
            child[parent] += t1 - t0
    spans, calls = {}, 0
    for i, (name, parent, call, t0, t1) in enumerate(_spans):
        if t1 is None:
            continue
        calls += parent is None and call is not None
        s = spans.setdefault(name, {"n": 0, "total_ms": 0.0, "self_ms": 0.0})
        s["n"] += 1
        s["total_ms"] += (t1 - t0) * 1e-6
        s["self_ms"] += (t1 - t0 - child[i]) * 1e-6
    return {"calls": calls, "spans": spans, "counters": dict(_counters)}


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler context over the block: CPU activity, and CUDA
    kernels where torch sees a card; the span records are reset on entry.
    On exit the timeline is written to `log_dir`/trace.json (Chrome trace
    format: chrome://tracing or Perfetto) and the spans and counters to
    `log_dir`/spans.json ({"records": records(), "snapshot":
    snapshot()}). Yields the profiler (key_averages() for sums by
    kernel)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump({"records": records(), "snapshot": snapshot()}, f)
