"""The benchmark's own host spans, and the device trace of the traced run.

Spans are recorded by the benchmark's files around its calls into the
program (``dispatch``, ``result``, ``enhance``, ``step``, ``feed``) and
around the parts of set-up (``SETUP_SPANS``), on the host clock, in every
run. With ``--trace 1`` a slice of ``TRACE_SECONDS`` of the same work is
profiled with ``torch.profiler`` after the window has closed, so that the
window runs as in an untraced run: the profiler is never started before it
(once started, CUPTI slows every later launch). Serving, whose load comes
from the client's clock, profiles a slice in the middle of its window
instead. CUDA activity only, since recording every host op as well slowed
the training step's host side enough to idle the card; no schedule, since a
warm-up step on a schedule returned empty traces on the H100. The device is
synchronized at both ends, so that the slice holds exactly the work issued
inside it. Of the slice: the seconds in which
anything ran on the device (the union of kernel, copy and set intervals),
the device seconds of each of the port's kernels (by the names of its kernel
registry, ``<name>..._kernel``), the device operations that took most time,
and the idle gaps named by the span open on the host at each gap's middle
(the trace's clock is the wall clock, mapped onto the host clock at start).
"""

from __future__ import annotations

import contextlib
import re
import threading
import time
from collections import defaultdict

import torch

# the traced slice: this long, after the window (serving: centred in the
# window, or the whole window when that is shorter)
TRACE_SECONDS = 4.0
# the parts of set-up that the traffic kinds span: making the inputs,
# building the system with the seed's weights, warming every shape
SETUP_SPANS = ("inputs", "build", "warm")


class Spans:
    """Named host intervals, from any thread."""

    def __init__(self):
        self.items: list[tuple[str, float, float]] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            with self._lock:
                self.items.append((name, t0, t1))

    def durations(self, name: str, t0: float, t1: float) -> list[float]:
        return [b - a for n, a, b in self.items if n == name and t0 <= a < t1]


def slice_bounds(t0: float, seconds: float) -> tuple[float, float]:
    """Host times at which the traced slice inside a serving window from
    ``t0`` opens and closes."""
    length = min(TRACE_SECONDS, seconds)
    start = t0 + (seconds - length) / 2
    return start, start + length


class Tracer:
    """Profiles one slice of the window when the run is traced."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.wall_minus_host = self.t0 = self.t1 = None

    def start(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.wall_minus_host = time.time() - time.perf_counter()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if not self.enabled or self.prof is None or self.t1 is not None:
            return
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def summarize(self, spans: Spans) -> dict | None:
        """Busy and window seconds, device seconds by operation name, the
        top device operations and the idle gaps of the slice; None if
        untraced."""
        if self.prof is None or self.t1 is None:
            return None
        from torch.autograd import DeviceType

        events = self.prof.events()
        start = self.prof.profiler.kineto_results.trace_start_ns() * 1e-9
        offset = start - self.wall_minus_host
        intervals, by_name = [], defaultdict(float)
        for e in events:
            if e.device_type == DeviceType.CUDA:
                a = max(e.time_range.start * 1e-6 + offset, self.t0)
                b = min(e.time_range.end * 1e-6 + offset, self.t1)
                if b > a:
                    intervals.append((a, b))
                    by_name[e.name] += b - a
        busy, gaps = _union(intervals, self.t0, self.t1)
        idle = defaultdict(float)
        open_spans = [s for s in spans.items if s[2] > self.t0 and s[1] < self.t1]
        for a, b in gaps:
            idle[_open_span(open_spans, (a + b) / 2)] += b - a
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        return {
            "busy_s": busy, "window_s": self.t1 - self.t0, "by_name": dict(by_name),
            "device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])[:10]],
        }


def kernel_s(summary: dict, names: tuple[str, ...]) -> float:
    """Device seconds of the port's kernels ``names`` (its kernel registry's
    records: CUDA functions ``<name>..._kernel``) in a summary."""
    pats = [re.compile(rf"(?<![A-Za-z_]){n}\w*?_kernel(?![a-z])") for n in names]
    return sum(t for k, t in summary["by_name"].items() if any(p.search(k) for p in pats))


def _union(intervals, t0: float, t1: float):
    """Seconds covered by ``intervals`` and the gaps between them in
    ``[t0, t1]``."""
    busy, gaps, cur = 0.0, [], t0
    for a, b in sorted(intervals):
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if t1 > cur:
        gaps.append((cur, t1))
    return busy, gaps


def _open_span(spans: list, t: float) -> str:
    """The innermost (latest started) of ``spans`` open at host time ``t``."""
    best, best_start = "none", -1.0
    for name, a, b in spans:
        if a <= t < b and a > best_start:
            best, best_start = name, a
    return best
