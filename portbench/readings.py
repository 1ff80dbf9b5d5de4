"""The numbers a cell's check compares, over many seeds in one process.

    python3 portbench/readings.py --workload <name> --variant sound
        --seeds 11,12,13 --seconds 3 [--out readings.jsonl]

`--variant` is `sound` (the program as the cell runs it), `control` (the
precision below the configuration's: the engine's own int8 path, or the
reference in float8 in the training step's place) or `fault:<name>` (the
timed path broken as the cell's traffic kind lists in FAULTS). Each seed
is a whole run at the cell's own sizes with a short window; one JSON line
per seed gives its checks and end-to-end metrics. The limits in
limits/<workload>.json are set from these readings (README.md).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", default="sound")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.find(args.workload)
    variant = None if args.variant == "sound" else args.variant
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            out = harness.run_cell(cell, seed, args.seconds, False,
                                   time.perf_counter(), variant=variant,
                                   log=lambda m: None)
            line = json.dumps({"workload": args.workload,
                               "variant": args.variant, "seed": seed,
                               "checks": {k: c["value"] for k, c
                                          in out["checks"].items()},
                               "metrics": {k: m["value"] for k, m
                                           in out["metrics"].items()},
                               "setup_reference_s": out["setup_reference_s"],
                               "kernels_built": out["kernels_built"],
                               "detail": out.get("detail")})
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
