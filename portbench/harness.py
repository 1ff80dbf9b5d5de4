"""The benchmark's harness: finds a cell by name and runs it.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own, found by the name `BENCHMARK.json`
gives it:

  configs/<config>.json   the configuration's sizes (the manifest's `file`)
  traffic/<traffic>.json  the mix; its "kind" names the generator in
                          kinds/<kind>.py that reads it
  metrics/<metric>.py     a per-layer metric's reader: read(run) -> number
                          or None
  limits/<workload>.json  the limit of each number the check compares

A run: set-up (everything before the first timed call, counted in
`setup_s` less the reference's own work in it, which the line gives as
`setup_reference_s`; `kernels_built` counts the kernel libraries this
set-up compiled), the window (units of work until `--seconds` have
passed, the one in flight finished), the peak memory, the program's
state freed, the check against the reference, the look for JAX in
`sys.modules`, and one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "zenker_audio_detection_tpu")
PROGRAM = "zenker_audio_detection_tpu_torch"


@dataclasses.dataclass
class Cell:
    name: str
    base: Path  # the benchmark's directory
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: dict  # metric name -> its manifest entry

    @property
    def kind(self) -> str:
        return self.mix["kind"]


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _load_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise LookupError(f"no {what} file {path}")
    with open(path) as f:
        return json.load(f)


def find(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell `name` of the manifest, with its files read."""
    bench = bench or manifest(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise LookupError(f"no workload {name!r}; the manifest has "
                          f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    if w["config"] not in configs:
        raise LookupError(f"workload {name!r} names no known config "
                          f"{w['config']!r}")
    base = root / HERE.name
    config = _load_json(root / configs[w["config"]]["file"], "config")
    mix = _load_json(base / "traffic" / f"{w['traffic']}.json", "traffic")
    limits = _load_json(base / "limits" / f"{name}.json", "limits")
    e2e = [m["name"] for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise LookupError(f"per-layer metric {m['name']!r} lists no "
                              "workloads")
    per_layer = {m["name"]: m for m in bench["per_layer"]
                 if name in m["workloads"]}
    for metric in per_layer:
        reader_path(base, metric)
    if not (base / "kinds" / f"{mix['kind']}.py").is_file():
        raise LookupError(f"no generator kinds/{mix['kind']}.py for the "
                          f"traffic kind of {w['traffic']!r}")
    return Cell(name, base, int(w["chips"]), config, mix, limits, e2e,
                per_layer)


def reader_path(base: Path, metric: str) -> Path:
    path = base / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise LookupError(f"no reader {path} for per-layer metric {metric!r}")
    return path


def reader(base: Path, metric: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}",
        reader_path(base, metric))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def driver_class(kind: str):
    return importlib.import_module(f"portbench.kinds.{kind}").Driver


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def counters() -> dict:
    """The program's launch counters of its attention kernels."""
    attn = sys.modules.get(f"{PROGRAM}.ops.attention")
    if attn is None:
        return {}
    out = {}
    for name in dir(attn):
        launches = getattr(getattr(attn, name), "launches", None)
        if isinstance(launches, int):
            out[name] = launches
    return out


def kernel_libraries() -> set:
    """The program's built kernel libraries in the checkout: a run whose
    set-up adds one has compiled, and its setup_s holds the build."""
    return set((ROOT / "build" / "torch_kernels").glob("*.so"))


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads: the cell, the traced window, the
    work completed in it and the program's counters over it."""
    cell: Cell
    trace: object
    tally: dict
    counters: dict


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", variant: str | None = None,
             log=print) -> dict:
    """One run of `cell`; returns the result line's object."""
    import torch

    from . import tracing

    cuda = torch.device(device).type == "cuda"
    drv = driver_class(cell.kind)(cell, seed, torch.device(device), variant)
    libraries = kernel_libraries()
    drv.setup()
    built = len(kernel_libraries() - libraries)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    drv.mark()
    before = counters()
    t0 = time.perf_counter()
    # set-up less the reference's own work in it (the heads' calibration,
    # the reference front end's features)
    setup_s = t0 - t_start - drv.reference_s
    limit = cell.mix["trace_seconds"] if trace else seconds

    def window():
        start = time.perf_counter()
        while True:
            drv.unit()
            if time.perf_counter() - start >= limit:
                break

    traced = None
    if trace:
        _, traced = tracing.profile(window)
    else:
        window()
        if cuda:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = counters()
    attempted, failed = drv.attempted()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    out = {"correct": False, "attempted": attempted, "failed": failed,
           "setup_reference_s": drv.reference_s, "kernels_built": built}
    if trace:
        run = Run(cell, traced, drv.tally(),
                  {k: after[k] - before.get(k, 0) for k in after})
        metrics = {}
        for name, entry in cell.per_layer.items():
            value = reader(cell.base, name)(run)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": entry["unit"]}
    else:
        metrics = {k: {"value": float(v), "unit": u}
                   for k, (v, u) in drv.metrics(wall).items()
                   if k in cell.end_to_end}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    out["metrics"] = metrics
    out["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        out["device"].update(busy_s=traced.busy_s, window_s=traced.window_s)
        out["breakdown"] = traced.breakdown()
    drv.release()
    numbers = drv.check()
    checks = {}
    for key, value in numbers.items():
        lim = cell.limits[key]["limit"]
        checks[key] = {"value": value, "limit": lim}
    out["correct"] = failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())  # NaN fails
    if getattr(drv, "detail", None):
        out["detail"] = drv.detail
    out["checks"] = checks
    for key, c in checks.items():
        log(f"[check] {key} {c['value']!r} limit {c['limit']!r}")
    return out


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    cell = find(args.workload)
    importlib.import_module(PROGRAM)
    import torch

    if not torch.cuda.is_available():
        log("portbench: no CUDA device (torch.cuda.is_available() is "
            "false); no result")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"portbench: {args.workload} needs {cell.chips} CUDA devices, "
            f"{torch.cuda.device_count()} present; no result")
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start,
                   log=log)
    found = forbidden_modules()
    if found:
        log(f"portbench: JAX or the JAX package loaded: {found}; no result")
        return 3
    print(json.dumps(out), flush=True)
    return 0
