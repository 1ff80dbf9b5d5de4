"""Base 5-fold CV splitter CLI (reference utils/PrepareTrainingData_AST_cv.py)."""

import argparse

from ..data import config as env_config, splits


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Patient-level 5-fold CV splits over the short-clip tree.")
    ap.add_argument("--dataset-root",
                    help="Class/<patient>/*.wav tree (default: SHORT_AUDIO_DIR)")
    ap.add_argument("--output-dir", default="data_ast_cv")
    ap.add_argument("--num-folds", type=int, default=5)
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    root = args.dataset_root or env_config.get_short_audio_dir()
    splits.make_base_cv_splits(root, args.output_dir, args.num_folds, args.seed)


if __name__ == "__main__":
    main()
