"""One-command real-asset validation CLI (round-3 VERDICT item #3).

Anyone holding the study's fine-tuned fold checkpoints
(<runs>/ast_classifier_stage{1,2}/fold{K}/best) and split data dirs can
prove quality parity against the paper's published confusion matrices
(reference utils/plot_confusion_matrices.py:168-184) in one command; see
analysis/validate.py for the chain and README "Reproducing the paper's
quality numbers" for the workflow.

The port's copy of the JAX CLI, with `--device` (default cuda, which raises
without a card):

    python -m zenker_audio_detection_tpu_torch.cli.validate_real --help
"""

import argparse
import sys

import torch

from ..analysis import validate


def main(argv=None):
    # manifest mode needs none of the required asset args: scan first
    if "--print-manifest" in (argv if argv is not None else sys.argv[1:]):
        print(validate.render_manifest_md())
        return
    ap = argparse.ArgumentParser(
        description="Validate real checkpoints + data against the paper's "
                    "published quality numbers (one command).")
    ap.add_argument("--print-manifest", action="store_true",
                    help="print the exact expected asset tree "
                         "(checkpoint name, split files, fold count, "
                         "paper eval-set Ns) and exit — check mounts "
                         "BEFORE running")
    ap.add_argument("--runs-dir", required=True,
                    help="runs root holding ast_classifier_stage{1,2}/"
                         "fold{K}/best")
    ap.add_argument("--data-stage1", required=True,
                    help="data_ast_stage1 split dir (npy paths must resolve "
                         "to real WAVs)")
    ap.add_argument("--data-stage2", required=True,
                    help="data_ast_stage2 split dir")
    ap.add_argument("--long-audio-root", default=None,
                    help="optional: long-audio tree for the cascade + "
                         "patient aggregation steps")
    ap.add_argument("--ids-root", default=None,
                    help="dir containing test_ids_fold{K}.txt "
                         "(default: --data-stage2)")
    ap.add_argument("--output-dir", default="validation")
    ap.add_argument("--folds", default=None,
                    help="comma-separated fold list (default 1-5)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--cm-tolerance", type=float, default=0.005,
                    help="per-cell CM tolerance as a fraction of the "
                         "evaluation-set size (default 0.5%% of windows "
                         "may flip at the framework boundary)")
    ap.add_argument("--aggregate-threshold", type=float, default=0.5,
                    help="ZSR threshold for the patient aggregation step")
    ap.add_argument("--skip-converter", action="store_true",
                    help="skip the torch logit-parity step")
    ap.add_argument("--f32", action="store_true",
                    help="evaluate in float32 (removes the bf16 boundary "
                         "from the comparison)")
    ap.add_argument("--device", default="cuda",
                    help="device the evaluation runs on (cuda, cuda:N or "
                         "cpu); cuda raises when CUDA is missing. The "
                         "converter check always runs on the CPU")
    args = ap.parse_args(argv)

    dtype = torch.float32 if args.f32 else None
    folds = ([int(f) for f in args.folds.split(",")]
             if args.folds else None)
    report = validate.run_validation(
        runs_dir=args.runs_dir, data_stage1=args.data_stage1,
        data_stage2=args.data_stage2,
        long_audio_root=args.long_audio_root, ids_root=args.ids_root,
        output_dir=args.output_dir, folds=folds,
        batch_size=args.batch_size, cm_tolerance=args.cm_tolerance,
        aggregate_threshold=args.aggregate_threshold,
        skip_converter=args.skip_converter, dtype=dtype, device=args.device)
    # 0 = paper CMs compared and matched; 1 = any check failed;
    # 2 = ran clean but the paper comparison never happened (eval-set
    # sizes differ — wrong splits or partial/synthetic data), so quality
    # parity is NOT established and CI must not treat this as a pass
    if not report["passed"]:
        sys.exit(1)
    sys.exit(0 if report["paper_comparable"] else 2)


if __name__ == "__main__":
    main()
