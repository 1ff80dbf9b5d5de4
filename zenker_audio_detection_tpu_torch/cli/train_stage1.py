"""Stage-1 (Idle vs Swallow) cross-validation trainer CLI
(reference src/train_ast_stage1_cross_validation.py), the port of the JAX
package's `cli/train_stage1.py`:

    python -m zenker_audio_detection_tpu_torch.cli.train_stage1 --help
"""

import argparse

from . import _train_common


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Fine-tune AST for Stage 1 (Idle vs Swallow) per fold.")
    _train_common.add_common_train_args(ap, "stage1")
    argv = _train_common.argv_list(argv)
    args = ap.parse_args(argv)
    folds = _train_common.validate_train_args(args)
    if _train_common.spawn_ranks(main, argv, args.num_devices,
                                 args.device)[0]:
        return

    from ..train import loop as train_loop

    cfg = _train_common.train_config(args, "stage1")
    train_loop.run_cross_validation(
        folds, cfg, tracking_opts=_train_common.tracking_opts(args))


if __name__ == "__main__":
    main()
