"""Tracing and throughput hooks.

Port of the JAX package's `utils/profiling.py`:

* `trace(logdir)`: a `torch.profiler` trace of the CPU and, where there is
  one, the CUDA activity of a block, written to `logdir` as a Chrome trace
  (`trace_<pid>.json`; open it in chrome://tracing or Perfetto);
* `Throughput`: an items/sec counter, a copy of the JAX package's.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(logdir: str | None):
    """A torch.profiler trace written to `logdir` when it is set; no-op
    otherwise."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}.json"))


class Throughput:
    """Accumulating items/sec counter.

    >>> tp = Throughput("windows")
    >>> with tp.measure(n_windows):
    ...     run()
    >>> tp.rate()
    """

    def __init__(self, unit: str = "items"):
        self.unit = unit
        self.items = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def measure(self, n: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds += time.perf_counter() - t0
            self.items += n

    def rate(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0

    def report(self) -> str:
        return (f"{self.items} {self.unit} in {self.seconds:.2f}s "
                f"= {self.rate():.1f} {self.unit}/s")
