"""Confusion-matrix plot CLI (reference utils/plot_confusion_matrices.py)."""

import argparse

from ..analysis import cm_plots


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Generate publication confusion matrices from model "
                    "results (falls back to the paper's CMs).")
    ap.add_argument("--model-root", default="runs")
    ap.add_argument("--output-dir", default=None,
                    help="default <model-root>/results")
    args = ap.parse_args(argv)
    cm_plots.plot_both_stages(args.model_root, args.output_dir)


if __name__ == "__main__":
    main()
