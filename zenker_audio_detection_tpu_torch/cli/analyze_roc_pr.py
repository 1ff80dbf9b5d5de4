"""ROC/PR analysis CLI (reference utils/analyze_ROC_PR_stage{1,2}.py;
the reference's --model-root-template flag with a {fold} placeholder is
kept, including the README discrepancy noted in SURVEY §0).

The port's copy of the JAX CLI, with `--device` (default cuda, which raises
without a card)."""

import argparse

import torch

from ..analysis import roc_pr
from ..infer.cascade import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="ROC/PR curves, bootstrap CIs and best-F1 operating "
                    "points per fold.")
    ap.add_argument("--stage", choices=["stage1", "stage2"], default="stage1")
    ap.add_argument("--data-dir", default=None,
                    help="default data_ast_<stage>")
    ap.add_argument("--model-root-template", default=None,
                    help="e.g. runs/ast_classifier_stage1/fold{fold}/best")
    ap.add_argument("--split", choices=["val", "test"], default="val",
                    help="val falls back to test when absent")
    ap.add_argument("--fold", type=int, default=None)
    ap.add_argument("--num-folds", type=int, default=5)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--decision-thresholds", type=float, nargs="+",
                    default=[0.5])
    ap.add_argument("--output-json")
    ap.add_argument("--plot", action="store_true",
                    help="Save ROC/PR plots")
    ap.add_argument("--plot-dir", default="analysis_plots")
    ap.add_argument("--plot-combined", action="store_true")
    ap.add_argument("--plot-individual", action="store_true")
    ap.add_argument("--plot-dpi", type=int, default=150)
    ap.add_argument("--plot-format", choices=["png", "pdf", "both"],
                    default="png")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device the scoring runs on (cuda, cuda:N or cpu); "
                         "cuda raises when CUDA is missing")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    data_dir = args.data_dir or f"data_ast_{args.stage}"
    template = args.model_root_template or \
        f"runs/ast_classifier_{args.stage}/fold{{fold}}/best"
    if args.fold is not None and not (1 <= args.fold <= args.num_folds):
        # without this, --fold 0 is falsy and silently analyzes ALL folds
        raise SystemExit(f"--fold must be in [1, {args.num_folds}]")
    folds = [args.fold] if args.fold else list(range(1, args.num_folds + 1))
    payload = roc_pr.analyze(
        data_dir, template, stage=args.stage, split=args.split, folds=folds,
        batch_size=args.batch_size,
        decision_thresholds=tuple(args.decision_thresholds),
        output_json=args.output_json,
        dtype=torch.float32 if args.f32 else torch.bfloat16, device=device)
    if args.plot:
        combined = args.plot_combined or (not args.plot_individual
                                          and not args.plot_combined)
        roc_pr.plot_payload(payload, args.plot_dir, stage=args.stage,
                            combined=combined,
                            individual=args.plot_individual,
                            dpi=args.plot_dpi, fmt=args.plot_format)


if __name__ == "__main__":
    main()
