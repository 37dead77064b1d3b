"""A traced slice of the window: ``torch.profiler`` over a few requests,
read back from its Chrome trace.

On the card the profiler records only device activity (kernels, copies,
memsets), which costs the host little; the benchmark's own host spans
(``pb.dispatch.<k>``, ``pb.sync.<k>``, taken with ``time.time_ns``) are
placed on the trace's timeline through its ``baseTimeNanoseconds``.  The
slice runs from the first dispatch to the end of the last sync.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import tempfile
import time
from pathlib import Path

DEVICE_CATEGORIES = {"kernel", "gpu_memcpy", "gpu_memset"}
SPAN_PREFIX = "pb."


@dataclasses.dataclass
class TraceSlice:
    frames: int
    device_ops: list  # (name, start_us, dur_us)
    host_spans: list  # (name, start_us, dur_us)

    @property
    def start_us(self) -> float:
        return min(s for _, s, _ in self.host_spans)

    @property
    def end_us(self) -> float:
        return max(s + d for _, s, d in self.host_spans)

    @property
    def span_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals inside the slice,
        as sorted, disjoint (start, end) pairs in us."""
        lo, hi = self.start_us, self.end_us
        spans = sorted(
            (max(s, lo), min(s + d, hi)) for _, s, d in self.device_ops if s + d > lo and s < hi
        )
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [tuple(m) for m in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_seconds(self) -> float:
        """The summed duration of every device operation in the slice."""
        return sum(d for _, _, d in self.device_ops) * 1e-6

    def seconds_by_op(self) -> list:
        """[[name, seconds], ...], the most time first."""
        total = {}
        for name, _, d in self.device_ops:
            total[name] = total.get(name, 0.0) + d * 1e-6
        return sorted(([n, s] for n, s in total.items()), key=lambda p: -p[1])

    def idle_gaps(self) -> list:
        """[[what the host was doing, seconds], ...] for each stretch of the
        slice in which no device operation ran, the longest first."""
        edges = [self.start_us]
        for s, e in self.busy_intervals():
            edges += [s, e]
        edges.append(self.end_us)
        gaps = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append([self.host_activity((a + b) / 2), (b - a) * 1e-6])
        return sorted(gaps, key=lambda p: -p[1])

    def host_activity(self, t_us: float) -> str:
        for name, s, d in self.host_spans:
            if s <= t_us <= s + d:
                kind, k = name[len(SPAN_PREFIX):].split(".")
                return f"{kind} request {k}"
        return "between requests"


class HostSpans:
    """``span(name)`` marks a stretch of host time (wall clock, ns)."""

    def __init__(self):
        self.spans = []  # (name, start_ns, end_ns)

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))


def read_chrome_trace(path: Path, frames: int, spans: HostSpans) -> TraceSlice:
    data = json.loads(Path(path).read_text())
    base_ns = int(data["baseTimeNanoseconds"])
    ops = []
    for ev in data["traceEvents"]:
        if ev.get("ph") == "X" and str(ev.get("cat", "")).lower() in DEVICE_CATEGORIES:
            ops.append((ev["name"], float(ev["ts"]), float(ev.get("dur", 0.0))))
    host = [(n, (a - base_ns) * 1e-3, (b - a) * 1e-3) for n, a, b in spans.spans]
    if not host:
        raise RuntimeError("the slice holds none of the benchmark's spans")
    return TraceSlice(frames=frames, device_ops=ops, host_spans=host)


def traced(run, frames: int, cuda: bool):
    """Run ``run(span)`` under the profiler, where ``span(name)`` marks a
    host span; return (its result, the TraceSlice).  On the CPU (the
    rehearsal) the profiler records host activity and the slice holds no
    device operation."""
    from torch.profiler import ProfilerActivity, profile

    spans = HostSpans()
    activity = ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU
    with profile(activities=[activity]) as prof:
        result = run(spans)
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "trace.json"
        prof.export_chrome_trace(str(path))
        return result, read_chrome_trace(path, frames, spans)
