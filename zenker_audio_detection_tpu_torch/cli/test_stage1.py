"""Stage-1 snippet evaluator CLI (reference src/test_trained_model_stage1_cv.py).

The port's copy of the JAX CLI, with `--device` (default cuda, which raises
without a card)."""

import argparse
import os

import torch

from ..analysis import snippet_eval
from ..infer.cascade import resolve_device


def run(stage: str, argv=None):
    ap = argparse.ArgumentParser(
        description=f"Evaluate trained {stage} models on fold test splits.")
    ap.add_argument("--fold", type=int, default=None)
    ap.add_argument("--all", action="store_true",
                    help="evaluate all folds + summed aggregate CM")
    ap.add_argument("--num-folds", type=int, default=5)
    ap.add_argument("--data-dir", default=f"data_ast_{stage}")
    ap.add_argument("--model-root", default=f"runs/ast_classifier_{stage}")
    ap.add_argument("--results-dir", default=None,
                    help="central results dir (default results/<stage>)")
    ap.add_argument("--mapping-path", "--class-mapping-path",
                    dest="mapping_path", default=None,
                    help="class_mapping.json path (reference name: "
                         "--class-mapping-path)")
    ap.add_argument("--use-aggregate-stats", action="store_true")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device the evaluation runs on (cuda, cuda:N or "
                         "cpu); cuda raises when CUDA is missing")
    # reference W&B surface (src/test_trained_model_stage1_cv.py:236-258):
    # opt-in here, unlike the trainers' opt-out --no-wandb
    ap.add_argument("--wandb", action="store_true",
                    help="log per-fold + aggregate CMs to a tracking run "
                         "(local-first; mirrors to wandb when installed)")
    ap.add_argument("--wandb-project", default=f"zd-audio-cv-eval-{stage}")
    ap.add_argument("--wandb-entity", default=None)
    ap.add_argument("--wandb-run-name", default=None)
    ap.add_argument("--wandb-group", default=f"cv-eval-{stage}")
    args = ap.parse_args(argv)
    if args.fold is not None and not (1 <= args.fold <= args.num_folds):
        # without this, --fold 0 is falsy and silently evaluates ALL folds
        raise SystemExit(f"--fold must be in [1, {args.num_folds}]")
    device = resolve_device(args.device)

    folds = (list(range(1, args.num_folds + 1)) if args.all or not args.fold
             else [args.fold])
    central = args.results_dir or os.path.join("results", stage)
    run = None
    if args.wandb:
        from ..utils import tracking

        name = args.wandb_run_name or (
            f"{stage}-cv-eval-fold{args.fold}" if args.fold
            else f"{stage}-cv-eval-all")
        run = tracking.Run(project=args.wandb_project, name=name,
                           group=args.wandb_group, entity=args.wandb_entity,
                           config={"stage": stage, "folds": folds,
                                   "model_root": args.model_root},
                           dir=os.path.join(args.model_root, "tracking"))
    summary = snippet_eval.evaluate_all_folds(
        stage=stage, data_dir=args.data_dir, model_root=args.model_root,
        central_results_dir=central, mapping_path=args.mapping_path,
        folds=folds, use_aggregate_stats=args.use_aggregate_stats,
        batch_size=args.batch_size,
        dtype=torch.float32 if args.f32 else torch.bfloat16, run=run,
        device=device)
    if run is not None:
        if "aggregate" in summary:
            run.summary(**summary["aggregate"])
        run.finish()


def main(argv=None):
    run("stage1", argv)


if __name__ == "__main__":
    main()
