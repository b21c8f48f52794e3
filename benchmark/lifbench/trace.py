"""The reading of a torch.profiler trace of the measured window.

Device activity (kernels, copies, fills) comes from the profiler's raw
events; each is tied to the host event that launched it by its linked
correlation id, so a kernel launched inside a PyTorch operator is told
apart from one launched through ctypes or Triton. The window is the span
of the harness's own "lifbench.call" annotations.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

CALL_SPAN = "lifbench.call"
TOP = 10


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    torch_op: bool  # launched inside a PyTorch (aten::) operator

    @property
    def kernel(self) -> bool:
        return not self.name.startswith(("Memcpy", "Memset"))


@dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: list = field(default_factory=list)  # DeviceOp in the window
    # (what the host was doing, seconds) over the device's idle time
    gaps: list = field(default_factory=list)

    def breakdown(self):
        by_name = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + (
                op.end_ns - op.start_ns) * 1e-9
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        by_host = {}
        for name, s in self.gaps:
            by_host[name] = by_host.get(name, 0.0) + s
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:120], s] for n, s in top],
                "idle_gaps": [[n[:120], s] for n, s in gaps]}


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_during(starts, host, calls, a, b):
    """What the host was doing over (a, b): [(activity, ns)], each
    instant given to the innermost operator or runtime call running
    then (the latest started of those running), else to Python inside
    or between the harness's calls."""
    i = bisect.bisect_left(starts, b)
    running = [h for h in host[max(0, i - 64):i] if h[1] > a]
    j = bisect.bisect_left(calls, (b,))
    cuts = sorted({a, b} | {t for s, e, *_ in running + calls[max(0, j - 2):j]
                            for t in (s, e) if a < t < b})
    out = []
    for p, q in zip(cuts, cuts[1:]):
        mid = (p + q) / 2
        inner = [h for h in running if h[0] <= mid < h[1]]
        if inner:
            name = max(inner)[2]
        else:
            k = bisect.bisect_right(calls, (mid, float("inf"))) - 1
            inside = k >= 0 and calls[k][1] > mid
            name = ("python between operators" if inside
                    else "between calls")
        out.append((name, q - p))
    return out


def read(prof) -> Trace | None:
    """The device activity of the profiled window, or None where the
    trace holds no call annotation."""
    from torch.autograd import DeviceType

    host, dev, names = [], [], {}
    calls = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            names[e.correlation_id()] = name
            if name == CALL_SPAN:
                calls.append((start, end))
            else:
                host.append((start, end, name))
        elif not name.startswith("lifbench.") and not e.is_user_annotation():
            dev.append((start, end, name, e.linked_correlation_id()))
    if not calls:
        return None
    w0 = min(s for s, _ in calls)
    w1 = max(e for _, e in calls)
    ops = [DeviceOp(n, s, e, names.get(c, "").startswith("aten::"))
           for s, e, n, c in dev if e > w0 and s < w1]
    busy = _union([(max(o.start_ns, w0), min(o.end_ns, w1)) for o in ops])
    host.sort()
    calls.sort()
    starts = [h[0] for h in host]
    gaps, t = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > t:
            gaps += [(name, ns * 1e-9) for name, ns in
                     _host_during(starts, host, calls, t, s)]
        t = max(t, e)
    return Trace(window_s=(w1 - w0) * 1e-9,
                 busy_s=sum(e - s for s, e in busy) * 1e-9, ops=ops,
                 gaps=gaps)
