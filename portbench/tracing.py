"""The traced window: a `torch.profiler` trace reduced to what the
per-layer readers need.

The trace is exported in the Chrome format to a temporary directory (under
TMPDIR), read back and deleted. Device activity is every event of the
categories in DEVICE: kernels, copies and fills. The window is the
benchmark's own span WINDOW_SPAN around the traced work.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from collections import defaultdict

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
HOST = ("cpu_op", "user_annotation")
WINDOW_SPAN = "portbench.window"
NAME_CHARS = 120


@dataclasses.dataclass
class Trace:
    """Device events (name, start, end, category) and host events
    (name, start, end), in microseconds, clipped to the window."""

    start: float
    end: float
    device: list
    host: list

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    def kernels(self) -> list:
        return [e for e in self.device if e[3] == "kernel"]

    def busy(self) -> list:
        """The union of the device events' intervals, merged, in order."""
        merged: list = []
        for _, s, e, _ in sorted(self.device, key=lambda d: d[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e6

    def gaps(self) -> list:
        """(start, end) of every stretch of the window with no device
        event."""
        out, at = [], self.start
        for s, e in self.busy():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.end > at:
            out.append((at, self.end))
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time
        by the innermost host operation running at each gap's middle."""
        ops: dict = defaultdict(float)
        for name, s, e, _ in self.device:
            ops[name[:NAME_CHARS]] += (e - s) / 1e6
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        idle: dict = defaultdict(float)
        for s, e in self.gaps():
            mid = (s + e) / 2
            name = "host (no operation)"
            i = bisect.bisect_right(starts, mid)
            for h in reversed(host[max(0, i - 512): i]):
                if h[2] >= mid:
                    name = h[0][:NAME_CHARS]
                    break
            idle[name] += (e - s) / 1e6
        rank = lambda d: sorted(([k, v] for k, v in d.items()),
                                key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def from_chrome(events: list) -> Trace:
    """The Trace of a Chrome-format event list holding one WINDOW_SPAN."""
    spans = [e for e in events if e.get("name") == WINDOW_SPAN
             and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if not spans:
        raise ValueError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0 = min(float(e["ts"]) for e in spans)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    device, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        s, t = max(s, w0), min(t, w1)
        if t < s:
            continue
        if e.get("cat") in DEVICE:
            device.append((e["name"], s, t, e["cat"]))
        elif e.get("cat") in HOST and e["name"] != WINDOW_SPAN:
            host.append((e["name"], s, t))
    return Trace(w0, w1, device, host)


def profile(fn):
    """Runs fn() inside WINDOW_SPAN under the profiler; returns (fn's
    result, Trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    with _profile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            result = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return result, from_chrome(events)
