"""The traced stretch of a window, and its reduction.

A traced run profiles a steady stretch of a few seconds inside its window
(``torch.profiler``, host and device activity), with the host spans that
the window's hooks open as ``record_function`` ranges named
``bench::<span>``. The stretch starts and ends on a synchronise, so the
device work in it is exactly the work the host queued in it. Its chrome
trace is written to a temporary file, reduced here and deleted; no trace
of the whole window is kept.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench::"
STRETCH = SPAN_PREFIX + "stretch"
OTHER_HOST = "solve loop, other host work"


def warm_profiler() -> None:
    """Start and stop the profiler once, so that a stretch inside the
    window does not pay the tracer's first start (seconds with CUPTI)."""
    Stretch(0.0, 0.0, lambda: None).poll()


class Stretch:
    """Profiles ``length`` seconds of the host clock (perf_counter) from
    the first poll() at or after ``start``; poll() is called from inside
    the window's loop. ``t_req`` is that poll's time, before the profiler
    started, and [t_req, t1] the host time the stretch disturbed."""

    def __init__(self, start: float, length: float, sync):
        self.start, self.length = start, length
        self.sync = sync
        self.prof = None
        self.mark = None
        self.t_req = self.t0 = self.t1 = None

    @property
    def active(self) -> bool:
        return self.t0 is not None and self.t1 is None

    def poll(self) -> None:
        now = time.perf_counter()
        if self.t0 is None and now >= self.start:
            self.t_req = now
            import torch
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self.sync()
            self.prof = profile(activities=acts)
            self.prof.start()
            self.mark = record_function(STRETCH)
            self.mark.__enter__()
            self.t0 = time.perf_counter()
            if self.length <= 0:
                self.stop()
        elif self.active and now >= self.t0 + self.length:
            self.stop()

    def stop(self) -> None:
        if not self.active:
            return
        self.sync()  # the mark then spans all the work queued in it
        self.mark.__exit__(None, None, None)
        self.t1 = time.perf_counter()
        self.prof.stop()

    def reduce(self) -> dict | None:
        if self.prof is None:
            return None
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        self.prof = None
        return reduce_events(events)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class _Spans:
    """Innermost bench:: span containing a time (spans nest shallowly)."""

    def __init__(self, spans):
        spans = sorted(spans)
        self.starts = [s[0] for s in spans]
        self.spans = spans

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        for k in range(i, max(i - 8, -1), -1):
            a, b, name = self.spans[k]
            if a <= t <= b:
                return name
        return None


def reduce_events(events) -> dict:
    """From a chrome trace's events: the stretch's length, the device's
    busy time (union of its operations, on any stream), device seconds by
    operation name and by the host span that launched the operation,
    idle seconds by the host span the device waited through, and the
    number of each span."""
    stretch = None
    spans, launches, device = [], {}, []
    for e in events:
        cat, name = e.get("cat"), e.get("name", "")
        if "dur" not in e or "ts" not in e:
            continue
        ts, dur = float(e["ts"]), float(e["dur"])
        if cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            if name == STRETCH:
                stretch = (ts, ts + dur)
            else:
                spans.append((ts, ts + dur, name[len(SPAN_PREFIX):]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = ts
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, name,
                           e.get("args", {}).get("correlation")))
    if stretch is None:
        if not device:
            return {"window_s": 0.0, "busy_s": 0.0, "device_s": {},
                    "device_s_by_span": {}, "idle_s_by_span": {},
                    "span_counts": {}}
        stretch = (min(d[0] for d in device), max(d[1] for d in device))
    lo, hi = stretch
    spans = [s for s in spans if s[1] >= lo and s[0] <= hi]
    finder = _Spans(spans)
    by_name, by_span = {}, {}
    clipped = []
    for a, b, name, corr in device:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        clipped.append((a, b))
        sec = (b - a) / 1e6
        by_name[name] = by_name.get(name, 0.0) + sec
        span = finder.at(launches[corr]) if corr in launches else None
        key = span or OTHER_HOST
        by_span[key] = by_span.get(key, 0.0) + sec
    busy = _merge(clipped)
    idle, prev = {}, lo
    for a, b in busy + [[hi, hi]]:
        if a > prev:
            key = finder.at((a + prev) / 2) or OTHER_HOST
            idle[key] = idle.get(key, 0.0) + (a - prev) / 1e6
        prev = max(prev, b)
    counts = {}
    for a, _, name in spans:
        if lo <= a <= hi:
            counts[name] = counts.get(name, 0) + 1
    return {"window_s": (hi - lo) / 1e6,
            "busy_s": sum(b - a for a, b in busy) / 1e6,
            "device_s": by_name, "device_s_by_span": by_span,
            "idle_s_by_span": idle, "span_counts": counts}


def top(d: dict, k: int = 10, width: int = 80):
    return [[name[:width], sec] for name, sec in
            sorted(d.items(), key=lambda kv: kv[1], reverse=True)[:k]]
