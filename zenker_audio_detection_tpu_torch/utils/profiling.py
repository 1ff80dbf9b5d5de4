"""Tracing hooks.

* `trace(logdir)`: a `torch.profiler` trace of the CPU and, where there is
  one, the CUDA activity of a block, written to `logdir` as a Chrome trace
  (`trace_<pid>.json`; open it in chrome://tracing or Perfetto);
* `span(name)`: a named span of the program's own work, recorded only while
  a profiler runs.

The spans (the engine's `cascade.*`, the model's `ast.attention`, the train
step's `train.*`) are `record_function` ranges: Kineto puts them on the
trace's host rows, on the clock of the device's kernels, and shows each
kernel launched inside one under the same name on the device's row.
"""

from __future__ import annotations

import contextlib
import os

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A `torch.profiler.record_function(name)` range while a profiler is
    active; otherwise one shared no-op context. An ungated
    `record_function` costs about 10 us of host time a call even with no
    profiler running; the check costs under 1 us."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(logdir: str | None):
    """A torch.profiler trace written to `logdir` when it is set; no-op
    otherwise."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}.json"))
