"""Patient-level aggregation CLI (reference utils/aggregate_2stage_results.py).

The port's copy of the JAX package's `cli/aggregate_results.py` (pure Python).
"""

import argparse

from ..analysis import aggregate


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Aggregate two-stage per-patient inference JSON outputs.")
    ap.add_argument("--outputs-dir", default="outputs")
    ap.add_argument("--threshold", type=float, default=0.5,
                    help="Zenker ratio threshold for positive prediction.")
    ap.add_argument("--csv", help="Optional CSV path for per-patient rows.")
    ap.add_argument("--json", help="Optional JSON path for full summary.")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--store-output", action="store_true",
                    help="Store json and csv with default names in the "
                         "outputs folder.")
    args = ap.parse_args(argv)

    aggregate.aggregate_outputs(
        args.outputs_dir, args.threshold, csv_path=args.csv,
        json_path=args.json, store_output=args.store_output,
        verbose=args.verbose)


if __name__ == "__main__":
    main()
