"""Two-stage long-audio inference CLI.

Port of the JAX package's `cli/infer_long_audio.py`: the same flags and JSON
output schema (outputs/<pid>_2stage.json) and the same gating semantics,
served by the PyTorch engine. Differences: `--attention-impl` takes
`kernel` (the CUDA kernel, default) or `torch` (its plain version),
`--device` (default `cuda`) says where the engine runs, and `--trace-dir`
writes a `torch.profiler` Chrome trace with the engine's `cascade.*` and
the model's `ast.attention` spans. `--num-devices N` > 1 runs the
CLI on N ranks of a process group (parallel/launch.py starts them, one
per card, or joins torchrun's group): the models are replicated and each
window chunk is sharded over a 1-D mesh, or a ("dcn", "data") one with
`--num-slices`; the first rank writes the JSON.

Run: python -m zenker_audio_detection_tpu_torch.cli.infer_long_audio --help
"""

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..audio import io as aio
from ..infer import cascade as C
from ..infer import discovery
from ..models import convert
from ..parallel import mesh as pmesh
from ..train import loop as train_loop
from ..utils import fsio


def build_arg_parser():
    ap = argparse.ArgumentParser(
        description="Two-stage AST inference over two long audio files (windowed).")
    ap.add_argument("--stage1-model-root",
                    help="Stage1 model dir (Idle vs Swallow); auto from --fold")
    ap.add_argument("--stage2-model-root",
                    help="Stage2 model dir (Healthy vs Zenker); auto from --fold")
    ap.add_argument("--fold", type=int,
                    help="Fold number to auto-resolve model roots.")
    ap.add_argument("--model-root", default="runs",
                    help="runs root used with --fold")
    ap.add_argument("--file-a", help="Explicit path to first audio file.")
    ap.add_argument("--file-b", help="Explicit path to second audio file.")
    ap.add_argument("--patient-id", help="Patient/specimen id for discovery.")
    ap.add_argument("--long-audio-root",
                    help="Root searched recursively for patient id.")
    ap.add_argument("--pattern", default="*.wav")
    ap.add_argument("--window-sec", type=float, default=1.0)
    ap.add_argument("--hop-sec", type=float, default=0.5)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--stage1-threshold", type=float, default=0.5)
    ap.add_argument("--stage2-threshold", type=float, default=0.5)
    ap.add_argument("--stage1-forward-min-prob", type=float, default=None)
    ap.add_argument("--stage2-argmax", action="store_true")
    ap.add_argument("--output-json")
    ap.add_argument("--show-first-n", type=int, default=5)
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--plot-dir", default="outputs")
    ap.add_argument("--cache-dir", "--feature-cache-dir", dest="cache_dir",
                    default=os.path.join(".cache", "ast_features"),
                    help="frame-cache dir (reference name: "
                         "--feature-cache-dir)")
    ap.add_argument("--disable-cache", action="store_true")
    ap.add_argument("--refresh-cache", action="store_true")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--stage2-mode", choices=["gated", "all"], default="gated")
    ap.add_argument("--attention-impl", choices=["kernel", "torch"],
                    default="kernel",
                    help="kernel: the hand-written CUDA attention kernel; "
                         "torch: its plain PyTorch version")
    ap.add_argument("--device", default="cuda",
                    help="device the engine runs on (cuda, cuda:N or cpu)")
    ap.add_argument("--num-devices", type=int, default=None,
                    help="shard each window chunk over this many devices, "
                         "one rank each (models replicated); default single "
                         "device")
    ap.add_argument("--num-slices", type=int, default=None,
                    help="split --num-devices into this many slices "
                         "(hierarchical dcn x data mesh); default one "
                         "slice")
    ap.add_argument("--int8", action="store_true",
                    help="int8 encoder GEMMs (per-channel weights, per-token "
                         "activations); probabilities drift O(1e-2): "
                         "recalibrate thresholds on validation")
    ap.add_argument("--trace-dir", default=None,
                    help="write a torch.profiler Chrome trace of the "
                         "inference to this directory; it holds the "
                         "engine's cascade.* spans and an ast.attention "
                         "span around each attention call")
    return ap


def load_stage_spec(model_root: str, label_order) -> C.StageSpec:
    params, config = convert.load_hf_model_dir(model_root)
    mean, std = train_loop.load_feature_extractor_config(model_root)
    return C.StageSpec(params, config, mean, std, tuple(label_order))


def resolve_model_roots(args) -> tuple[str, str]:
    """--fold + --model-root -> the per-stage `fold{k}/best` dirs (the
    reference's runs layout, src/run_all_folds_simple_batch.sh:109-123);
    explicit --stage{1,2}-model-root wins."""
    if args.fold is not None:
        if not args.stage1_model_root:
            args.stage1_model_root = os.path.join(
                args.model_root, "ast_classifier_stage1",
                f"fold{args.fold}", "best")
        if not args.stage2_model_root:
            args.stage2_model_root = os.path.join(
                args.model_root, "ast_classifier_stage2",
                f"fold{args.fold}", "best")
    if not (args.stage1_model_root and args.stage2_model_root):
        raise ValueError(
            "Model roots must be provided either explicitly or via --fold.")
    return args.stage1_model_root, args.stage2_model_root


def load_stage_specs(args) -> tuple[C.StageSpec, C.StageSpec]:
    root1, root2 = resolve_model_roots(args)
    return (load_stage_spec(root1, ("Idle", "Swallow")),
            load_stage_spec(root2, ("Healthy", "Zenker")))


def build_engine(args) -> tuple[C.TwoStageEngine, str, str]:
    # resolve the device before loading ~700 MB of weights for nothing
    device = C.resolve_device(args.device)
    spec1, spec2 = load_stage_specs(args)
    config = C.CascadeConfig(
        window_sec=args.window_sec,
        hop_sec=args.hop_sec,
        batch_size=args.batch_size,
        stage1_threshold=args.stage1_threshold,
        stage2_threshold=args.stage2_threshold,
        stage1_forward_min_prob=args.stage1_forward_min_prob,
        stage2_argmax=args.stage2_argmax,
        dtype=torch.float32 if args.f32 else torch.bfloat16,
        cache_dir=None if args.disable_cache else args.cache_dir,
        refresh_cache=args.refresh_cache,
        stage2_mode=args.stage2_mode,
        attention_impl=args.attention_impl,
        int8=args.int8,
    )
    # a prebuilt mesh (fold-group serving, run_all_folds --data-per-fold)
    # takes precedence over constructing one from --num-devices
    mesh = getattr(args, "mesh", None)
    if mesh is None:
        mesh = pmesh.make_mesh(getattr(args, "num_devices", None),
                               getattr(args, "num_slices", None),
                               device=device)
    return (C.TwoStageEngine(spec1, spec2, config, device=device, mesh=mesh),
            args.stage1_model_root, args.stage2_model_root)


def resolve_files(args) -> list[str]:
    if args.file_a and args.file_b:
        return [args.file_a, args.file_b]
    if not (args.patient_id and args.long_audio_root):
        raise ValueError("Provide either --file-a & --file-b or "
                         "(--patient-id and --long-audio-root).")
    return discovery.discover_two_files(args.long_audio_root,
                                        args.patient_id, args.pattern)


def run_patient(engine: C.TwoStageEngine, files, args,
                stage1_root: str, stage2_root: str) -> dict:
    if args.window_sec <= 0 or args.hop_sec <= 0:
        raise ValueError("window-sec and hop-sec must be > 0")
    if args.hop_sec > args.window_sec:
        print("[WARN] hop-sec larger than window-sec; windows will be "
              "disjoint with gaps.")

    per_file = {}
    plot_assets = []
    # decode both recordings in parallel; mono-PCM16@16k files stay int16 —
    # the engine scales them on the device
    with ThreadPoolExecutor(max_workers=2) as pool:
        audios = list(pool.map(aio.load_audio_compact, files))
    for idx, (path, audio) in enumerate(zip(files, audios)):
        res = engine.infer_file(audio, path)
        n = res["num_windows"]
        print(f"File {idx}: {n} windows of {args.window_sec}s")
        if args.show_first_n > 0 and n:
            first_n = min(args.show_first_n, n)
            print(f"First {first_n} stage1 preds: "
                  f"{res['_s1_preds'][:first_n].tolist()}")
        per_file[f"file_{idx}"] = {
            k: v for k, v in res.items() if not k.startswith("_")}
        if args.plot:
            # the float32 copy of a full recording is ~230 MB/hour: only
            # made when a plot consumes it
            plot_audio = (audio.astype(np.float32) / 32768.0
                          if audio.dtype == np.int16 else audio)
            plot_assets.append((plot_audio, res["_s1_preds"],
                                res["_stage2_aligned_classes"],
                                f"file_{idx}", path))

    output = C.build_patient_output(engine.config, files, per_file,
                                    stage1_root, stage2_root)
    aggregate = output["aggregate"]
    if engine.mesh is not None:
        if not pmesh.is_main(engine.mesh):  # the first rank writes
            return output

    if not args.output_json and args.patient_id:
        os.makedirs("outputs", exist_ok=True)
        args.output_json = os.path.join("outputs",
                                        f"{args.patient_id}_2stage.json")
    if args.output_json:
        # atomic: batch drivers trust any EXISTING per-patient JSON
        # (skip-if-exists), so a kill mid-write must not leave a truncated
        # file that a rerun then permanently skips
        fsio.atomic_json_dump(output, args.output_json, indent=2)
        print(f"Saved JSON: {args.output_json}")

    if args.plot:
        from ..infer import plotting

        plotting.plot_two_stage(plot_assets, args.window_sec, args.hop_sec,
                                args.plot_dir, args.patient_id,
                                cached_name=getattr(args, "plot_cached_name",
                                                    False))

    print("\n=== Aggregate (Two-Stage) Summary ===")
    print(json.dumps(aggregate, indent=2))
    return output


def main(argv=None):
    from . import _train_common

    argv = _train_common.argv_list(argv)
    args = build_arg_parser().parse_args(argv)
    spawned, result = _train_common.spawn_ranks(main, argv, args.num_devices,
                                                args.device)
    if spawned:
        return result
    files = resolve_files(args)
    print(f"Using files:\n  A: {files[0]}\n  B: {files[1]}")
    engine, s1_root, s2_root = build_engine(args)

    from ..utils import profiling

    with profiling.trace(args.trace_dir):
        return run_patient(engine, files, args, s1_root, s2_root)


if __name__ == "__main__":
    main()
