"""Normalization-stats CLI (reference utils/compute_ast_normalization_stats.py),
the port of the JAX package's `cli/compute_stats.py`, with `--device`:

    python -m zenker_audio_detection_tpu_torch.cli.compute_stats --help
"""

import argparse
import os

from ..data import stats


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Compute AST normalization stats across CV folds.")
    ap.add_argument("--data-dir", default="data_ast_cv")
    ap.add_argument("--folds", type=int, default=5)
    ap.add_argument("--output-dir", default=None,
                    help="defaults to --data-dir")
    ap.add_argument("--stage", choices=["stage1", "stage2"],
                    help="shortcut: use data_ast_stage1/2 as data+output dir")
    ap.add_argument("--batch-size", type=int, default=16,
                    help="accepted for reference CLI parity "
                         "(utils/compute_ast_normalization_stats.py); here "
                         "the clips go through the log-mel in batches of one "
                         "length, so this flag does not change numerics or "
                         "apply")
    ap.add_argument("--device", default="cuda",
                    help="device the log-mel runs on (cuda, cuda:N or cpu); "
                         "cuda raises when CUDA is missing")
    args = ap.parse_args(argv)

    data_dir = args.data_dir
    output_dir = args.output_dir or data_dir
    if args.stage:
        data_dir = output_dir = os.path.join(os.getcwd(),
                                             f"data_ast_{args.stage}")
        print(f"[Info] Using stage alias '{args.stage}' -> '{data_dir}'")
    per_fold, aggregate = stats.compute_all_stats(data_dir, output_dir,
                                                  args.folds, args.device)
    print(f"\nWeighted aggregate: mean={aggregate['mean']:.6f} "
          f"std={aggregate['std']:.6f} (total_count={aggregate['total_count']})")


if __name__ == "__main__":
    main()
