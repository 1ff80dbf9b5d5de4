"""Stage-2 (Healthy vs Zenker) cross-validation trainer CLI
(reference src/train_ast_stage2_cross_validation.py), the port of the JAX
package's `cli/train_stage2.py`: focal loss with label smoothing +
inverse-frequency class weights + batch-level alpha balancing, or weighted
CE with --no-focal-loss.

    python -m zenker_audio_detection_tpu_torch.cli.train_stage2 --help
"""

import argparse

from . import _train_common


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Fine-tune AST for Stage 2 (Healthy vs Zenker) per fold.")
    _train_common.add_common_train_args(ap, "stage2")
    ap.add_argument("--focal-alpha", type=float, default=0.25)
    ap.add_argument("--no-focal-loss", action="store_true",
                    help="weighted CE instead of focal loss")
    ap.add_argument("--no-class-weights", action="store_true")
    argv = _train_common.argv_list(argv)
    args = ap.parse_args(argv)
    folds = _train_common.validate_train_args(args)
    if _train_common.spawn_ranks(main, argv, args.num_devices,
                                 args.device)[0]:
        return

    from ..train import loop as train_loop

    cfg = _train_common.train_config(
        args, "stage2", focal_alpha=args.focal_alpha,
        use_focal_loss=not args.no_focal_loss,
        use_class_weights=not args.no_class_weights)
    train_loop.run_cross_validation(
        folds, cfg, tracking_opts=_train_common.tracking_opts(args))


if __name__ == "__main__":
    main()
