"""All-folds batch driver (reference src/run_all_folds_simple_batch.sh):
loops folds 1..N through run_batch_2stage, sourcing LONG_AUDIO_ROOT from
.env, auto-detecting optimal_thresholds_per_fold_both_stages.json, and
writing per-fold outputs under <model-dir>/results/patient_inference.

Port of the JAX package's `cli/run_all_folds.py`. --parallel-folds serves
every fold CONCURRENTLY, one thread per fold, fold K's resident engine on
`cuda:((K-1) mod torch.cuda.device_count())` (with `--device cpu`, every
fold on the CPU): fold batches are independent (distinct models, disjoint
patients), so N cards serve the whole study at about one fold's wall
clock, and the shared output dir never collides.

Over several devices (parallel/launch.py starts one rank per device, or
torchrun's group is joined): `--num-devices N` (`--num-slices`) shards
every fold's window chunks over N ranks, fold after fold;
`--parallel-folds --data-per-fold D` gives each fold a group of D ranks
sharing its window chunks, fold K on group (K-1) mod the group count, the
groups serving at once. The groups are the cards in groups of D (on the
CPU one group per fold).

Run: python -m zenker_audio_detection_tpu_torch.cli.run_all_folds --help
"""

import argparse
import os

from . import run_batch_2stage
from ..data import config as env_config
from ..parallel import mesh as pmesh


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Run two-stage batch inference for all folds.")
    ap.add_argument("model_dir", nargs="?", default="runs",
                    help="runs root containing ast_classifier_stage{1,2}/")
    ap.add_argument("--long-audio-root",
                    help="default: LONG_AUDIO_ROOT from .env")
    ap.add_argument("--ids-root", default="data_ast_stage2")
    ap.add_argument("--num-folds", type=int, default=5)
    ap.add_argument("--output-dir", default=None,
                    help="default: <model_dir>/results/patient_inference")
    ap.add_argument("--no-threshold-config", action="store_true")
    ap.add_argument("--threshold-config", default=None)
    ap.add_argument("--stage1-forward-min-prob", type=float, default=None)
    ap.add_argument("--stage2-argmax", action="store_true")
    ap.add_argument("--pattern", default="*.wav",
                    help="recording filename glob forwarded to each fold's "
                         "batch run (reference wrapper PATTERN, "
                         "src/run_all_folds_simple_batch.sh:26)")
    ap.add_argument("--plot", action="store_true",
                    help="per-patient two-stage plots in each fold's batch "
                         "run; the reference wrapper hardcodes this ON with "
                         "an edit-the-script opt-out (PLOT_FLAG, "
                         "run_all_folds_simple_batch.sh:86-87) — here it is "
                         "an explicit flag, default off")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of every fold's engine (cuda, cuda:N or "
                         "cpu); with --parallel-folds and cuda, fold K runs "
                         "on cuda:((K-1) mod device count)")
    ap.add_argument("--num-devices", type=int, default=None,
                    help="shard window chunks over this many devices")
    ap.add_argument("--num-slices", type=int, default=None,
                    help="split --num-devices into this many slices")
    ap.add_argument("--int8", action="store_true",
                    help="int8 encoder GEMMs (see infer_long_audio --int8)")
    ap.add_argument("--parallel-folds", action="store_true",
                    help="serve all folds concurrently, one thread and "
                         "fold-resident engine per fold (fold K on "
                         "cuda:((K-1) mod device count))")
    ap.add_argument("--data-per-fold", type=int, default=None,
                    help="with --parallel-folds: give each fold's resident "
                         "engine its own group of this many devices and "
                         "shard its window chunks across the group (fold K "
                         "on device group (K-1) mod the group count)")
    ap.add_argument("--aggregate", action="store_true",
                    help="run the per-patient aggregator over the output "
                         "dir when all folds finish (the reference leaves "
                         "this as a manual utils/aggregate_2stage_results"
                         ".py step, SURVEY §3.4)")
    ap.add_argument("--aggregate-threshold", type=float, default=0.5,
                    help="patient ZSR decision threshold for --aggregate")
    from . import _train_common

    argv = _train_common.argv_list(argv)
    args = ap.parse_args(argv)
    if args.parallel_folds and (args.num_devices or args.num_slices):
        raise SystemExit("--parallel-folds pins one fold per device (or "
                         "device group with --data-per-fold); it is "
                         "incompatible with --num-devices/--num-slices "
                         "window sharding")
    groups = None
    if args.data_per_fold is not None:
        if not args.parallel_folds:
            raise SystemExit("--data-per-fold requires --parallel-folds")
        if args.data_per_fold < 1:
            raise SystemExit("--data-per-fold must be >= 1")
        if run_batch_2stage.DEFAULT_BATCH_SIZE % args.data_per_fold:
            # fail fast here instead of identical [FAIL] lines after
            # every fold group has built its engine
            raise SystemExit(
                "--data-per-fold must divide the engine batch size "
                f"({run_batch_2stage.DEFAULT_BATCH_SIZE})")
        if args.data_per_fold > 1 and not args.dry_run:
            groups = _fold_groups(args)
    ranks = (groups * args.data_per_fold if groups
             else args.num_devices)
    spawned, _ = _train_common.spawn_ranks(main, argv, ranks, args.device)
    if spawned:
        return

    long_root = args.long_audio_root or \
        env_config.load_dataset_config()["long_audio_root"]
    out_dir = args.output_dir or os.path.join(args.model_dir, "results",
                                              "patient_inference")

    threshold_config = args.threshold_config
    if threshold_config is None and not args.no_threshold_config:
        candidate = os.path.join(
            args.model_dir, "optimal_thresholds_per_fold_both_stages.json")
        if os.path.exists(candidate):
            threshold_config = candidate
            print(f"[Thresholds] auto-using {candidate}")

    def fold_args(fold: int) -> list[str]:
        sub = ["--fold", str(fold),
               "--ids-root", args.ids_root,
               "--long-audio-root", long_root,
               "--output-dir", out_dir,
               "--model-root", args.model_dir,
               "--stage1-model-root",
               os.path.join(args.model_dir, "ast_classifier_stage1",
                            f"fold{fold}", "best"),
               "--stage2-model-root",
               os.path.join(args.model_dir, "ast_classifier_stage2",
                            f"fold{fold}", "best")]
        if threshold_config:
            sub += ["--threshold-config", threshold_config]
        if args.stage1_forward_min_prob is not None:
            sub += ["--stage1-forward-min-prob",
                    str(args.stage1_forward_min_prob)]
        if args.stage2_argmax:
            sub.append("--stage2-argmax")
        sub += ["--pattern", args.pattern]
        if args.plot:
            sub.append("--plot")
        if args.force:
            sub.append("--force")
        if args.dry_run:
            sub.append("--dry-run")
        if args.f32:
            sub.append("--f32")
        sub += ["--device", args.device]
        if args.num_devices is not None:
            sub += ["--num-devices", str(args.num_devices)]
        if args.num_slices is not None:
            sub += ["--num-slices", str(args.num_slices)]
        if args.int8:
            sub.append("--int8")
        return sub

    folds = list(range(1, args.num_folds + 1))
    patient_failures = 0
    failed_folds: list[int] = []
    if groups:
        failed_folds, patient_failures = _serve_fold_groups(
            args, folds, groups, fold_args)
        if not pmesh.is_main():  # the first rank aggregates and reports
            return
    elif args.parallel_folds and not args.dry_run:
        from concurrent.futures import ThreadPoolExecutor

        import torch

        from ..infer import cascade as C

        base = C.resolve_device(args.device)  # raises without a card

        def serve_fold(fold):
            device = base
            if base.type == "cuda":
                device = torch.device(
                    "cuda", (fold - 1) % torch.cuda.device_count())
            print(f"\n===== Fold {fold}/{args.num_folds} on {device} =====")
            return run_batch_2stage.main(fold_args(fold), device=str(device))

        with ThreadPoolExecutor(max_workers=len(folds)) as pool:
            futures = {pool.submit(serve_fold, f): f for f in folds}
            for fut, fold in futures.items():
                try:
                    patient_failures += fut.result()["failed"]
                except Exception as exc:  # per-fold isolation, like the
                    failed_folds.append(fold)  # per-patient handling inside
                    print(f"[FAIL] fold {fold}: {exc}")
    else:
        for fold in folds:
            print(f"\n===== Fold {fold}/{args.num_folds} =====")
            counts = run_batch_2stage.main(fold_args(fold))
            if counts:
                patient_failures += counts["failed"]
        if not pmesh.is_main():  # the first rank aggregates and reports
            return

    if args.aggregate and not args.dry_run:
        from . import aggregate_results

        if patient_failures or failed_folds:
            # partial study: say so loudly (the reference's manual
            # aggregation step implied a human had checked the batch logs)
            print(f"\n[WARN] {patient_failures} patient(s) and "
                  f"{len(failed_folds)} fold(s) {failed_folds or ''} FAILED "
                  "batch inference; the aggregate below covers completed "
                  "patients only")
        print("\n===== Aggregate (patient-level ZSR decisions) =====")
        aggregate_results.main([
            "--outputs-dir", out_dir,
            "--threshold", str(args.aggregate_threshold),
            "--store-output"])
    if failed_folds:
        # exit nonzero AFTER aggregating completed folds — the sequential
        # path tolerates partial failures the same way
        raise SystemExit(f"folds failed: {failed_folds}")


def _fold_groups(args) -> int:
    """How many groups of --data-per-fold devices serve the folds: the
    cards in groups of D, or on the CPU one group per fold."""
    import torch

    from ..infer import cascade as C

    D = args.data_per_fold
    if C.resolve_device(args.device).type == "cpu":
        return args.num_folds
    visible = torch.cuda.device_count()
    if D > visible:
        raise SystemExit(f"--data-per-fold {D}: only {visible} devices "
                         "visible")
    return visible // D


def _serve_fold_groups(args, folds, groups: int, fold_args):
    """In each rank: serve this rank's group's folds, fold K on group
    (K-1) mod `groups`, over the group's "data" sub-mesh; returns (failed
    folds, failed patients) of every group."""
    D = args.data_per_fold
    mesh = pmesh.fold_data_mesh(groups * D, D, device=args.device)
    group = mesh[pmesh.DATA_AXIS]
    g = pmesh.mesh_rank(mesh) // D
    failed_folds, patient_failures = [], 0
    for fold in folds:
        if (fold - 1) % groups != g:
            continue
        print(f"\n===== Fold {fold}/{args.num_folds} on group {g} "
              f"({D} devices) =====")
        try:
            patient_failures += run_batch_2stage.main(
                fold_args(fold), mesh=group)["failed"]
        except Exception as exc:  # per-fold isolation, like the
            failed_folds.append(fold)  # per-patient handling inside
            print(f"[FAIL] fold {fold}: {exc}")
    every = pmesh.all_gather_objects((failed_folds, patient_failures))
    return (sorted(f for fs, _ in every[::D] for f in fs),
            sum(n for _, n in every[::D]))


if __name__ == "__main__":
    main()
