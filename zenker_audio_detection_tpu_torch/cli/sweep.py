"""Local sweep-agent CLI (replaces `wandb agent` over the reference's
wandb_sweeps/*.yaml; the same YAML format, see tune/sweep.py).

The port's copy of the JAX package's `cli/sweep.py`, with `--device`
(default cuda; the CPU only when named). `--parallel-trials` trains every
trial at once in one vmapped step on that device
(train/trial_parallel.py). `--num-devices N` > 1 runs the agent on N
ranks of a process group (parallel/launch.py, or torchrun's): each
sequential trial data-parallel over them, or with `--parallel-trials` the
trial axis split over them (`--data-per-trial` ranks per trial). PyYAML
is needed to read the sweep YAML.

    python -m zenker_audio_detection_tpu_torch.cli.sweep \\
        sweeps/sweep_stage1_comprehensive.yaml --stage stage1 \\
        --data-dir <d> --parallel-trials --count 4
"""

import argparse

from ..train import loop as train_loop
from ..tune import sweep as sweep_mod
from . import _train_common


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Run a local random-search hyperparameter sweep.")
    ap.add_argument("sweep_config", help="W&B-format sweep YAML")
    ap.add_argument("--stage", choices=["stage1", "stage2"], required=True)
    ap.add_argument("--count", type=int, default=10,
                    help="number of trials")
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--pretrained-model-dir", default=None)
    ap.add_argument("--num-epochs", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--output-dir", default="sweep_results")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-augment", action="store_true")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device every trial runs on (cuda, cuda:N or "
                         "cpu); cuda raises when CUDA is missing")
    ap.add_argument("--max-length", type=int, default=None,
                    help="short-sequence trials (e.g. 128)")
    ap.add_argument("--streaming", action="store_true",
                    help="stream train featurization per batch")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="micro-batches of --batch-size accumulated per "
                         "optimizer update in each trial (beyond-parity "
                         "batch scaling; incompatible with "
                         "--parallel-trials)")
    ap.add_argument("--num-devices", type=int, default=None,
                    help="data-parallel devices per trial (or the trial "
                         "mesh size with --parallel-trials)")
    ap.add_argument("--data-per-trial", type=int, default=None,
                    help="with --parallel-trials: give each concurrent "
                         "trial its own group of this many devices and "
                         "shard the shared batch across the group (2-D "
                         "trial x data mesh; each group's gradients are "
                         "summed over the group only). --num-devices must "
                         "be group-size * group-count")
    ap.add_argument("--parallel-trials", action="store_true",
                    help="train ALL trials at once in one vmapped step, "
                         "the trial axis split over --num-devices "
                         "(train/trial_parallel.py): the trials share one "
                         "data batch per step, only params/opt-state/"
                         "hyperparameters are per-trial; Hyperband cuts "
                         "use the simultaneous-median rule. Incompatible "
                         "with --streaming")
    argv = _train_common.argv_list(argv)
    args = ap.parse_args(argv)
    if args.num_devices is not None and args.num_devices < 1:
        raise SystemExit("--num-devices must be >= 1")
    if args.parallel_trials and args.streaming:
        raise SystemExit("--parallel-trials is incompatible with "
                         "--streaming (eager featurization only)")
    if args.grad_accum < 1:
        raise SystemExit("--grad-accum must be >= 1")
    if args.grad_accum > 1 and args.parallel_trials:
        raise SystemExit("--grad-accum > 1 is incompatible with "
                         "--parallel-trials (trials share one data batch "
                         "per step; scale data via --data-per-trial "
                         "device groups instead)")
    if args.data_per_trial is not None:
        if not args.parallel_trials:
            raise SystemExit("--data-per-trial requires --parallel-trials")
        if args.data_per_trial < 1:
            raise SystemExit("--data-per-trial must be >= 1")
        if args.data_per_trial > 1 and not args.num_devices:
            raise SystemExit("--data-per-trial requires an explicit "
                             "--num-devices (= group-size * group-count)")
        if (args.num_devices or 1) % args.data_per_trial:
            raise SystemExit("--num-devices must be a multiple of "
                             "--data-per-trial")
    if _train_common.spawn_ranks(main, argv, args.num_devices,
                                 args.device)[0]:
        return

    import torch

    from ..infer.cascade import resolve_device

    resolve_device(args.device)  # before any file is written
    base = train_loop.TrainFoldConfig(
        stage=args.stage,
        data_dir=args.data_dir or f"data_ast_{args.stage}",
        output_root=args.output_dir,
        pretrained_model_dir=args.pretrained_model_dir,
        num_epochs=args.num_epochs,
        batch_size=args.batch_size,
        grad_accum=args.grad_accum,
        use_class_weights=args.stage == "stage2",
        # the trainer CLIs' stage defaults (_train_common.py): a YAML that
        # does not sweep these trains the objective that re-running the
        # best config through train_stage2 would
        focal_gamma=0.0 if args.stage == "stage1" else 2.0,
        label_smoothing=0.0 if args.stage == "stage1" else 0.1,
        augment=not args.no_augment,
        dtype=torch.float32 if args.f32 else torch.bfloat16,
        device=args.device,
        max_length=args.max_length,
        streaming=args.streaming,
        num_devices=args.num_devices,
        data_per_fold=args.data_per_trial,
    )
    out = sweep_mod.run_sweep(args.sweep_config, base, count=args.count,
                              seed=args.seed, output_dir=args.output_dir,
                              parallel_trials=args.parallel_trials)
    best = out["best"]
    if best is None:
        print("\nNo completed trials (count=0 or empty sample space); "
              "no best to report")
        return
    print(f"\nBest trial {best['trial']}: value={best['value']:.4f} "
          f"params={best['params']}")


if __name__ == "__main__":
    main()
