"""Two-stage dataset derivation CLI (reference
utils/PrepareTrainingData_AST_cv_2stage.py and the _capped variant — pass
--max-files-per-patient to enable capping)."""

import argparse

from ..data import splits


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Derive Stage-1/Stage-2 datasets from base CV artifacts.")
    ap.add_argument("--cv-dir", default="data_ast_cv")
    ap.add_argument("--out-stage1", default="data_ast_stage1")
    ap.add_argument("--out-stage2", default="data_ast_stage2")
    ap.add_argument("--num-folds", type=int, default=5)
    ap.add_argument("--val-ratio", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--val-mode", choices=["random", "per-fold"],
                    default="random")
    ap.add_argument("--max-files-per-patient", type=int, default=None,
                    help="enable Stage-2-only per-patient capping")
    args = ap.parse_args(argv)

    opts = splits.TwoStageOptions(
        num_folds=args.num_folds, val_ratio=args.val_ratio, seed=args.seed,
        val_mode=args.val_mode,
        max_files_per_patient=args.max_files_per_patient)
    splits.derive_two_stage_splits(args.cv_dir, args.out_stage1,
                                   args.out_stage2, opts)


if __name__ == "__main__":
    main()
