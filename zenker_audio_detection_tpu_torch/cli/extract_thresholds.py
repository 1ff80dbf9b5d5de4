"""Per-fold threshold extraction CLI (reference
utils/extract_thresholds_per_fold.py)."""

import argparse

from ..analysis import thresholds


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Extract per-fold optimal thresholds from validation "
                    "ROC/PR metrics.")
    ap.add_argument("--stage1-metrics",
                    help="Stage 1 validation ROC/PR metrics JSON")
    ap.add_argument("--stage2-metrics", required=True,
                    help="Stage 2 validation ROC/PR metrics JSON")
    ap.add_argument("--output-config",
                    default="optimal_thresholds_per_fold.json")
    args = ap.parse_args(argv)

    config = thresholds.build_threshold_config(
        args.stage2_metrics, args.stage1_metrics, args.output_config)
    if config:
        for fold in sorted(config["folds"], key=int):  # string keys: '10'>'2'
            fd = config["folds"][fold]
            line = f"Fold {fold}: stage2 {fd['stage2']['threshold']:.4f}"
            if "stage1" in fd:
                line += f", stage1 {fd['stage1']['threshold']:.4f}"
            print(line)


if __name__ == "__main__":
    main()
