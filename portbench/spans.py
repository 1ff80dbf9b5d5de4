"""The device's idle time inside the program's own spans.

The port names its work with `record_function` ranges
(`zenker_audio_detection_tpu_torch/utils/profiling.py:span`): the engine's
`cascade.*` and the train step's `train.*`. In the trace they are host
`user_annotation` events, on the clock of the device's kernels, so the idle
stretches of the window (`Trace.gaps`) can be cut at a span's ends. A
reader asks for the seconds of idle inside the union of some spans' host
intervals: each gap counts by the part of it that the union covers, and
nested or overlapping spans count once.
"""

from __future__ import annotations


def union(trace, names) -> list:
    """The merged (start, end) intervals of the trace's host events named
    in `names`, in order."""
    merged: list = []
    for s, e in sorted((s, e) for n, s, e in trace.host if n in names):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def idle_s(trace, names) -> float | None:
    """Seconds of the window with no device event while the host was
    inside a span of `names`; None when the trace holds no such span, or
    no device event at all (the device was not traced)."""
    spans = union(trace, names)
    if not spans or not trace.device:
        return None
    gaps = trace.gaps()
    total, i = 0.0, 0
    for gs, ge in gaps:
        while i < len(spans) and spans[i][1] <= gs:
            i += 1
        j = i
        while j < len(spans) and spans[j][0] < ge:
            total += min(ge, spans[j][1]) - max(gs, spans[j][0])
            j += 1
    return total / 1e6


def idle_pct(trace, names) -> float | None:
    """`idle_s` as a share of the traced window's wall time, in %."""
    idle = idle_s(trace, names)
    return None if idle is None else 100.0 * idle / trace.window_s
