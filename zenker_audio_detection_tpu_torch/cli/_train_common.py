"""Shared argparse surface for the stage trainers (reference CLI flags at
src/train_ast_stage1_cross_validation.py:651-758 and the stage-2 twin).

The port's copy of the JAX package's `cli/_train_common.py`, with
`--device`. `--parallel-folds` trains the target folds at once in one
vmapped step (train/fold_parallel.py). `--num-devices N` > 1 runs the
trainer on N ranks of a process group (parallel/launch.py starts them,
one per card, or joins torchrun's group): data-parallel over a 1-D mesh,
over a ("dcn", "data") mesh with `--num-slices`, or the fold axis over the
ranks with `--parallel-folds` (and `--data-per-fold` ranks per fold)."""

from __future__ import annotations

import argparse
import sys


def add_common_train_args(ap: argparse.ArgumentParser, stage: str) -> None:
    s1 = stage == "stage1"
    ap.add_argument("--fold", type=int, default=None,
                    help="1-based fold; omit to run all folds")
    ap.add_argument("--num-folds", type=int, default=5)
    ap.add_argument("--data-dir", default=f"data_ast_{stage}")
    ap.add_argument("--output-root", default=f"runs/ast_classifier_{stage}")
    ap.add_argument("--pretrained-model-dir", default=None,
                    help="HF model dir of MIT/ast-finetuned-audioset-10-10-0.4593 "
                         "(no hub download in this framework); omit for random init")
    ap.add_argument("--num-epochs", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=16)
    # reference defaults: stage1 :688-727, stage2 :777-784
    ap.add_argument("--learning-rate", type=float, default=5e-5)
    ap.add_argument("--weight-decay", type=float, default=0.01)
    ap.add_argument("--warmup-ratio", type=float, default=0.1)
    ap.add_argument("--adam-beta2", type=float, default=0.98)
    ap.add_argument("--focal-gamma", type=float, default=0.0 if s1 else 2.0)
    ap.add_argument("--label-smoothing", type=float, default=0.0 if s1 else 0.1)
    ap.add_argument("--dry-run", action="store_true",
                    help="32 samples, 1 epoch, checkpoint limit 1, skip CMs")
    ap.add_argument("--no-early-stopping", "--disable-early-stopping",
                    dest="no_early_stopping", action="store_true",
                    help="disable early stopping (reference name: "
                         "--disable-early-stopping)")
    ap.add_argument("--optim", default="adamw_torch_fused",
                    help="optimizer identifier, reference CLI parity "
                         "(src/train_ast_stage1_cross_validation.py:706-709). "
                         "Any AdamW identifier maps onto the port's AdamW "
                         "update (train/optim.py, the optax chain); other "
                         "identifiers are rejected")
    ap.add_argument("--no-augment", action="store_true")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--resume", action="store_true",
                    help="resume each fold from its latest checkpoint")
    ap.add_argument("--f32", action="store_true",
                    help="train in float32 instead of bfloat16")
    ap.add_argument("--device", default="cuda",
                    help="device the whole loop runs on (cuda, cuda:N or "
                         "cpu); cuda raises when CUDA is missing")
    ap.add_argument("--num-devices", type=int, default=None,
                    help="data-parallel devices: one rank each, params "
                         "replicated, batch rows sharded over a 1-D mesh "
                         "(default: single device)")
    ap.add_argument("--num-slices", type=int, default=None,
                    help="split --num-devices into this many slices: a "
                         "hierarchical (dcn, data) mesh, each slice's ranks "
                         "contiguous (default: one slice)")
    ap.add_argument("--parallel-folds", action="store_true",
                    help="train all target folds at once in ONE vmapped "
                         "step (train/fold_parallel.py), the fold axis "
                         "split over --num-devices: each fold keeps its own "
                         "weights, optimizer state, LR schedule and early "
                         "stopping, with the sequential trainer's numerics. "
                         "Incompatible with --streaming, --resume and "
                         "--grad-accum > 1")
    ap.add_argument("--data-per-fold", type=int, default=None,
                    help="with --parallel-folds: give each concurrent fold "
                         "its own group of this many devices and shard the "
                         "fold's batch rows across the group (2-D fold x "
                         "data mesh; each fold's gradient is summed over its "
                         "group only). --num-devices must be group-size * "
                         "group-count")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="beyond-parity batch scaling: accumulate this many "
                         "micro-batches of --batch-size per optimizer "
                         "update (effective batch = batch-size * "
                         "grad-accum; --num-devices shards each batch, it "
                         "does not grow it. LR warmup/decay count optimizer "
                         "steps). Default 1 = the reference's one update "
                         "per batch")
    ap.add_argument("--scale-lr", action="store_true",
                    help="linearly scale --learning-rate by the effective-"
                         "batch ratio vs the reference's 16 (lr *= "
                         "batch-size * grad-accum / 16) — the standard "
                         "large-batch recipe; warmup_ratio provides the "
                         "ramp")
    ap.add_argument("--streaming", action="store_true",
                    help="stream train featurization per batch (O(batch) "
                         "host memory, background prefetch, identical "
                         "numerics) instead of eager whole-split features")
    ap.add_argument("--max-length", type=int, default=None,
                    help="short-sequence mode: fine-tune at this many input "
                         "frames (e.g. 128 for 1 s windows, ~10x fewer FLOPs "
                         "than the checkpoint's 1024); positional embeddings "
                         "are cut on the time axis (AST paper trick). "
                         "Default: keep the checkpoint's length")
    # observability (reference W&B surface; local tracking always on)
    ap.add_argument("--no-wandb", action="store_true",
                    help="disable the wandb mirror (local tracking remains)")
    ap.add_argument("--wandb-project", default=None)
    ap.add_argument("--wandb-entity", default=None,
                    help="W&B entity/user/team (mirror only)")
    ap.add_argument("--wandb-group", default=None)
    ap.add_argument("--wandb-offline", action="store_true")
    ap.add_argument("--wandb-per-fold", action="store_true",
                    help="one tracking run per fold (grouped) plus a "
                         "cv_summary run, like the reference's "
                         "--wandb-per-fold")


def tracking_opts(args) -> dict:
    return {"enabled": not args.no_wandb, "project": args.wandb_project,
            "entity": args.wandb_entity, "group": args.wandb_group,
            "offline": args.wandb_offline, "per_fold": args.wandb_per_fold}


def effective_lr(args) -> float:
    """--scale-lr: linear LR scaling by the effective-batch ratio vs the
    reference's 16 (src/train_ast_stage1_cross_validation.py:484) — the
    standard large-batch recipe (Goyal et al.); warmup_ratio already
    provides the ramp and the schedule counts optimizer steps. The
    effective batch is batch_size * grad_accum: --batch-size is the global
    batch, which --num-devices shards without changing the update."""
    if not getattr(args, "scale_lr", False):
        return args.learning_rate
    eff = args.batch_size * args.grad_accum
    lr = args.learning_rate * eff / 16.0
    print(f"[ScaleLR] effective batch {eff} -> lr "
          f"{args.learning_rate:g} * {eff}/16 = {lr:g}")
    return lr


def validate_train_args(args) -> list[int]:
    if args.fold is not None and not (1 <= args.fold <= args.num_folds):
        raise SystemExit(f"--fold must be in [1, {args.num_folds}]")
    if not (0 <= args.label_smoothing < 1):
        raise SystemExit("--label-smoothing must be in [0, 1)")
    if args.focal_gamma < 0:
        raise SystemExit("--focal-gamma must be >= 0")
    if args.num_devices is not None and args.num_devices < 1:
        raise SystemExit("--num-devices must be >= 1")
    if args.num_slices is not None:
        if args.num_slices < 1:
            raise SystemExit("--num-slices must be >= 1")
        if args.num_slices > 1 and (args.num_devices or 1) % args.num_slices:
            raise SystemExit("--num-devices must be a multiple of "
                             "--num-slices")
    if args.parallel_folds and (args.streaming or args.resume):
        raise SystemExit("--parallel-folds is incompatible with "
                         "--streaming/--resume (eager featurization only; "
                         "resume folds with the sequential path)")
    if args.parallel_folds and args.grad_accum > 1:
        raise SystemExit("--grad-accum > 1 is incompatible with "
                         "--parallel-folds")
    if "adamw" not in args.optim.lower():
        raise SystemExit(
            f"--optim {args.optim!r}: only AdamW identifiers are supported "
            "(the training step is an AdamW update)")
    if args.grad_accum < 1:
        raise SystemExit("--grad-accum must be >= 1")
    if args.data_per_fold is not None:
        if not args.parallel_folds:
            raise SystemExit("--data-per-fold requires --parallel-folds")
        if args.data_per_fold < 1:
            raise SystemExit("--data-per-fold must be >= 1")
        if args.data_per_fold > 1 and not args.num_devices:
            raise SystemExit("--data-per-fold requires an explicit "
                             "--num-devices (= group-size * group-count)")
        if (args.num_devices or 1) % args.data_per_fold:
            raise SystemExit("--num-devices must be a multiple of "
                             "--data-per-fold")
    return [args.fold] if args.fold else list(range(1, args.num_folds + 1))


def argv_list(argv) -> list[str]:
    """The arguments as a list (the command line's when None), to hand to
    the ranks a CLI starts."""
    return list(sys.argv[1:] if argv is None else argv)


def spawn_ranks(main, argv: list[str], num_devices, device):
    """When `num_devices` > 1 and no process group exists: run `main(argv)`
    on that many ranks (parallel/launch.py) and return (True, rank 0's
    result); else (False, None), the caller runs in place (under
    torchrun the group is joined here)."""
    from ..parallel import launch

    if not launch.should_spawn(num_devices, device):
        return False, None
    return True, launch.spawn(main, (argv,), num_devices, device)


def train_config(args, stage: str, **stage_kw):
    """The TrainFoldConfig of parsed arguments (both stages' common part;
    `stage_kw` the stage's own fields)."""
    import torch

    from ..train import loop as train_loop

    return train_loop.TrainFoldConfig(
        stage=stage,
        data_dir=args.data_dir,
        output_root=args.output_root,
        pretrained_model_dir=args.pretrained_model_dir,
        num_epochs=args.num_epochs,
        batch_size=args.batch_size,
        grad_accum=args.grad_accum,
        learning_rate=effective_lr(args),
        weight_decay=args.weight_decay,
        warmup_ratio=args.warmup_ratio,
        adam_beta2=args.adam_beta2,
        focal_gamma=args.focal_gamma,
        label_smoothing=args.label_smoothing,
        enable_early_stopping=not args.no_early_stopping,
        augment=not args.no_augment,
        dry_run=args.dry_run,
        seed=args.seed,
        resume=args.resume,
        dtype=torch.float32 if args.f32 else torch.bfloat16,
        device=args.device,
        max_length=args.max_length,
        streaming=args.streaming,
        num_devices=args.num_devices,
        num_slices=args.num_slices,
        fold_parallel=args.parallel_folds,
        data_per_fold=args.data_per_fold,
        **stage_kw,
    )
