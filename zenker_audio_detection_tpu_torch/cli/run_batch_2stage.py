"""Per-fold batch driver (reference src/run_batch_simple_2stage.py).

Port of the JAX package's `cli/run_batch_2stage.py`: the same CLI and
per-patient JSON contract. The fold's two models are loaded ONCE into a
resident engine and every patient is served from it (the reference spawns
a subprocess per patient and reloads both models each time, :282-284).
The engine runs on `--device` (default `cuda`; without a card that raises).
`--num-devices N` > 1 runs the driver on N ranks of a process group
(parallel/launch.py, or torchrun's) whose engine shards each window chunk
over them (`--num-slices`: a ("dcn", "data") mesh); a prebuilt `mesh`
(run_all_folds' fold groups) does the same over that mesh's ranks. The
first rank writes the JSONs.

Run: python -m zenker_audio_detection_tpu_torch.cli.run_batch_2stage --help
"""

import argparse
import json
import os
import traceback

from . import infer_long_audio
from ..parallel import mesh as pmesh


# default engine chunk size — shared with run_all_folds' upfront
# --data-per-fold divisibility validation
DEFAULT_BATCH_SIZE = 128


def read_ids(ids_path: str) -> list[str]:
    patients = []
    with open(ids_path) as f:
        for line in f:
            line = line.strip()
            if line:
                patients.append(line.split("/")[-1])
    return patients


def resolve_thresholds(config_path: str | None, fold: int):
    """(stage1_thr, stage2_thr) from per-fold or single-threshold config
    (reference :97-118); None where unspecified."""
    if not config_path or not os.path.exists(config_path):
        return None, None
    from ..analysis import thresholds as thr_mod

    out = thr_mod.load_fold_thresholds(config_path, fold)
    return out["stage1"], out["stage2"]


def main(argv=None, mesh=None, device=None):
    """`device` overrides --device (run_all_folds --parallel-folds pins
    each fold's engine to its own card so). `mesh`: optional prebuilt
    `DeviceMesh` for the fold-resident engine (run_all_folds
    --data-per-fold's device group); every rank of it calls this."""
    ap = argparse.ArgumentParser(
        description="Run two-stage inference for every test patient of a fold.")
    ap.add_argument("--fold", type=int, required=True)
    ap.add_argument("--ids-root", default="data_ast_stage2",
                    help="dir containing test_ids_fold{K}.txt")
    ap.add_argument("--long-audio-root", required=True)
    ap.add_argument("--pattern", default="*.wav")
    ap.add_argument("--window-sec", type=float, default=1.0)
    ap.add_argument("--hop-sec", type=float, default=0.5)
    ap.add_argument("--batch-size", type=int, default=DEFAULT_BATCH_SIZE)
    ap.add_argument("--output-dir", default="outputs")
    ap.add_argument("--model-root", default="runs")
    ap.add_argument("--stage1-model-root")
    ap.add_argument("--stage2-model-root")
    ap.add_argument("--threshold-config",
                    help="per-fold threshold JSON from extract_thresholds")
    ap.add_argument("--stage1-threshold", type=float, default=0.5)
    ap.add_argument("--stage2-threshold", type=float, default=0.5)
    ap.add_argument("--stage1-forward-min-prob", type=float, default=None)
    ap.add_argument("--stage2-argmax", action="store_true")
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="re-run even if the per-patient JSON exists")
    ap.add_argument("--dry-run", action="store_true",
                    help="print planned patients without running")
    ap.add_argument("--disable-cache", action="store_true")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--attention-impl", choices=["kernel", "torch"],
                    default="kernel",
                    help="kernel: the hand-written CUDA attention kernel; "
                         "torch: its plain PyTorch version")
    ap.add_argument("--device", default="cuda",
                    help="device the engine runs on (cuda, cuda:N or cpu)")
    ap.add_argument("--num-devices", type=int, default=None,
                    help="shard each window chunk over this many devices, "
                         "one rank each (models replicated)")
    ap.add_argument("--num-slices", type=int, default=None,
                    help="split --num-devices into this many slices "
                         "(hierarchical dcn x data mesh)")
    ap.add_argument("--int8", action="store_true",
                    help="int8 encoder GEMMs (see infer_long_audio --int8)")
    ap.add_argument("--extra", default=None,
                    help="additional raw argument string (reference "
                         "src/run_batch_simple_2stage.py:139-140 appends it "
                         "to each per-patient subprocess; here there is no "
                         "subprocess, so the tokens are parsed as extra "
                         "flags of THIS command and override its options, "
                         "e.g. --extra '--stage2-argmax --batch-size 64')")
    from . import _train_common

    argv = _train_common.argv_list(argv)
    args = ap.parse_args(argv)
    if args.extra:
        import shlex

        args = ap.parse_args(argv + shlex.split(args.extra))
    if mesh is None:
        spawned, result = _train_common.spawn_ranks(
            main, argv, args.num_devices, device or args.device)
        if spawned:
            return result

    ids_path = os.path.join(args.ids_root, f"test_ids_fold{args.fold}.txt")
    patients = read_ids(ids_path)
    print(f"[Fold {args.fold}] {len(patients)} test patients from {ids_path}")

    thr1, thr2 = resolve_thresholds(args.threshold_config, args.fold)
    if thr1 is not None:
        args.stage1_threshold = thr1
        print(f"[Thresholds] stage1 <- {thr1} (config)")
    if thr2 is not None:
        args.stage2_threshold = thr2
        print(f"[Thresholds] stage2 <- {thr2} (config)")

    os.makedirs(args.output_dir, exist_ok=True)

    # one resident engine for the whole fold
    infer_args = argparse.Namespace(
        fold=args.fold, model_root=args.model_root,
        stage1_model_root=args.stage1_model_root,
        stage2_model_root=args.stage2_model_root,
        window_sec=args.window_sec, hop_sec=args.hop_sec,
        batch_size=args.batch_size,
        stage1_threshold=args.stage1_threshold,
        stage2_threshold=args.stage2_threshold,
        stage1_forward_min_prob=args.stage1_forward_min_prob,
        stage2_argmax=args.stage2_argmax,
        cache_dir=os.path.join(".cache", "ast_features"),
        disable_cache=args.disable_cache, refresh_cache=False,
        f32=args.f32, plot=args.plot, plot_dir=args.output_dir,
        # the reference batch driver invokes the CACHE-variant script
        # (run_batch_simple_2stage.py SCRIPT_NAME), whose plot artifacts
        # are named {pid}_2stage_plot_cached.*
        plot_cached_name=True,
        num_devices=args.num_devices, num_slices=args.num_slices,
        mesh=mesh,
        stage2_mode="gated", attention_impl=args.attention_impl,
        device=device or args.device, int8=args.int8, trace_dir=None,
        show_first_n=0, pattern=args.pattern,
        long_audio_root=args.long_audio_root,
        output_json=None, patient_id=None, file_a=None, file_b=None)

    from concurrent.futures import ThreadPoolExecutor

    from ..infer import discovery

    def _valid_json(path):
        # skip-if-exists trusts the file forever, so only PARSEABLE results
        # count as done: a truncated JSON (pre-atomic-write kill, disk
        # hiccup) re-runs instead of silently poisoning the aggregate
        try:
            with open(path) as f:
                json.load(f)
            return True
        except (OSError, ValueError):
            print(f"[STALE] {path} is unreadable/corrupt; re-running")
            return False

    todo = []
    done = failed = skipped = 0
    for pid in patients:
        expected = os.path.join(args.output_dir, f"{pid}_2stage.json")
        if os.path.exists(expected) and not args.force \
                and _valid_json(expected):
            print(f"[SKIP] {pid} (exists: {expected})")
            skipped += 1
        elif args.dry_run:
            print(f"[DRY-RUN] would infer patient {pid} -> {expected}")
        else:
            todo.append((pid, expected))

    # every rank decides what to skip before the first writes a JSON
    if mesh is not None or (args.num_devices or 1) > 1:
        pmesh.barrier(mesh)

    def discover(pid):
        return discovery.discover_two_files(args.long_audio_root, pid,
                                            args.pattern)

    engine = None
    # prefetch: discover the next patient's files while the current one
    # runs on the device (decode itself happens inside run_patient)
    with ThreadPoolExecutor(max_workers=1) as pool:
        futures = {pid: pool.submit(discover, pid) for pid, _ in todo[:2]}
        for i, (pid, expected) in enumerate(todo):
            if i + 2 < len(todo):
                nxt = todo[i + 2][0]
                futures[nxt] = pool.submit(discover, nxt)
            if engine is None:
                engine, s1_root, s2_root = \
                    infer_long_audio.build_engine(infer_args)
            print(f"[RUN] {pid}")
            try:
                files = futures.pop(pid).result()
                infer_args.patient_id = pid
                infer_args.output_json = expected
                infer_long_audio.run_patient(engine, files, infer_args,
                                             s1_root, s2_root)
                done += 1
                print(f"[DONE] {pid}")
            except Exception as exc:
                failed += 1
                print(f"[FAIL] {pid}: {exc}")
                traceback.print_exc()
    print(f"[Fold {args.fold}] done={done} failed={failed} skipped={skipped}")
    return {"done": done, "failed": failed, "skipped": skipped}


if __name__ == "__main__":
    main()
