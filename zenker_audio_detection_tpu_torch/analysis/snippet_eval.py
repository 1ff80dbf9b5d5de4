"""Per-fold snippet evaluation (reference C10/C11:
src/test_trained_model_stage{1,2}_cv.py).

Loads each fold's `best` model, featurizes the fold's test split with the
fold's normalization stats (per-fold -> aggregate -> default resolution, with
`use_aggregate_stats` forcing the aggregate, :79-98), predicts, and writes:

  * <model_root>/fold{k}/best/evaluation/{confusion_matrix.npy,
    classification_report.txt, y_true.npy, y_pred.npy}
  * <central_results>/stage{N}/fold{k}_classification_report.txt
  * with all folds: summed CM + aggregate report under
    <model_root>/cv_aggregate_evaluation/ and the central results dir
    (:309-343) — this is the artifact the CM plotter consumes.

The port of the JAX package's `analysis/snippet_eval.py`: the fold's test
split is featurized and scored on `device` (CUDA unless the caller names
the CPU), bf16 by default, through `train.steps.make_eval_step` with the
model's default "torch" attention, as the JAX evaluator runs XLA's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data import stats as stats_mod
from ..infer.cascade import resolve_device
from ..models import ast as ast_mod, convert
from ..train import loop as train_loop, metrics as metrics_mod, steps

STAGE_FALLBACK_CLASSES = {
    "stage1": ["Idle", "Swallow"],
    "stage2": ["Healthy", "Zenker"],
}


def load_class_names(mapping_path: str | None, stage: str) -> list[str]:
    """Dynamic class order from class_mapping.json, stage fallback otherwise
    (reference load_class_names :40-71)."""
    if mapping_path and os.path.exists(mapping_path):
        from ..utils.fsio import load_json_object
        mapping = load_json_object(mapping_path, "class mapping")
        names = sorted(mapping, key=lambda k: mapping[k])
        if len(names) == 2:
            return names
    return STAGE_FALLBACK_CLASSES[stage]


def load_mean_std(data_dir: str, fold: int, use_aggregate: bool):
    if use_aggregate:
        agg = stats_mod.load_aggregate_normalization(data_dir)
        if agg is not None:
            return agg
    return stats_mod.load_fold_normalization(data_dir, fold)[:2]


def _log_cm(run, prefix: str, title: str, cm, class_names, out_dir: str):
    """Mirror a confusion matrix into the tracker: overlay plot as an image
    + counts table (reference wandb.plot.confusion_matrix + wandb.Table,
    src/test_trained_model_stage1_cv.py:199-217,344-365)."""
    if run is None:
        return
    try:
        from . import cm_plots

        png = os.path.join(out_dir, "confusion_matrix.png")
        cm_plots.plot_confusion_matrix_overlay(cm, class_names, title, png)
        run.log_image(f"{prefix}/confusion_matrix", png)
    except Exception as exc:  # plotting is best-effort, like the reference
        print(f"[tracking][WARN] CM plot for {prefix} failed: {exc}")
    run.log_table(f"{prefix}/confusion_matrix_counts",
                  ["class"] + list(class_names),
                  [[class_names[i]] + [int(v) for v in row]
                   for i, row in enumerate(cm)])


def evaluate_fold(fold: int, *, stage: str, data_dir: str, model_root: str,
                  central_results_dir: str, class_names: list[str],
                  use_aggregate_stats: bool = False, batch_size: int = 8,
                  dtype=None, run=None, device=None) -> dict:
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16

    from ..utils import fsio
    test_x = fsio.load_npy(os.path.join(data_dir, f"test_x_fold{fold}.npy"),
                           "split paths", allow_pickle=True).tolist()
    y_true = np.asarray(
        fsio.load_npy(os.path.join(data_dir, f"test_y_fold{fold}.npy"),
                      "split labels", allow_pickle=True), dtype=int)

    mean, std = load_mean_std(data_dir, fold, use_aggregate_stats)
    model_dir = os.path.join(model_root, f"fold{fold}", "best")
    params, config = convert.load_hf_model_dir(model_dir)

    feats = train_loop.featurize_paths(test_x, mean, std,
                                       max_frames=config.max_length,
                                       device=device)
    eval_step = steps.make_eval_step(config, dtype=dtype)
    logits = train_loop._predict(eval_step,
                                 ast_mod.cast_params(params, dtype, device),
                                 feats, batch_size, device)
    y_pred = logits.argmax(axis=1)

    cm, report = metrics_mod.confusion_and_report(y_true, y_pred, class_names)
    eval_dir = os.path.join(model_dir, "evaluation")
    os.makedirs(eval_dir, exist_ok=True)
    np.save(os.path.join(eval_dir, "confusion_matrix.npy"), cm)
    with open(os.path.join(eval_dir, "classification_report.txt"), "w") as f:
        f.write(report)
    np.save(os.path.join(eval_dir, "y_true.npy"), y_true)
    np.save(os.path.join(eval_dir, "y_pred.npy"), y_pred)

    os.makedirs(central_results_dir, exist_ok=True)
    with open(os.path.join(central_results_dir,
                           f"fold{fold}_classification_report.txt"), "w") as f:
        f.write(report)

    print(f"[Fold {fold}] {stage} test:")
    print(report)
    _log_cm(run, f"fold{fold}",
            f"{stage.capitalize()} Fold {fold} Confusion Matrix",
            cm, class_names, eval_dir)
    return {"fold": fold, "y_true": y_true, "y_pred": y_pred,
            "confusion_matrix": cm,
            **metrics_mod.binary_metrics(y_true, y_pred)}


def evaluate_all_folds(*, stage: str, data_dir: str, model_root: str,
                       central_results_dir: str,
                       mapping_path: str | None = None,
                       folds=None, use_aggregate_stats: bool = False,
                       batch_size: int = 8, dtype=None, run=None,
                       device=None) -> dict:
    class_names = load_class_names(
        mapping_path or os.path.join(data_dir, "class_mapping.json"), stage)
    folds = list(folds) if folds else list(range(1, 6))

    results = [evaluate_fold(f, stage=stage, data_dir=data_dir,
                             model_root=model_root,
                             central_results_dir=central_results_dir,
                             class_names=class_names,
                             use_aggregate_stats=use_aggregate_stats,
                             batch_size=batch_size, dtype=dtype, run=run,
                             device=device)
               for f in folds]

    summary = {"per_fold": [{k: v for k, v in r.items()
                             if k not in ("y_true", "y_pred",
                                          "confusion_matrix")}
                            for r in results]}
    if len(results) > 1:
        all_true = np.concatenate([r["y_true"] for r in results])
        all_pred = np.concatenate([r["y_pred"] for r in results])
        agg_cm, agg_report = metrics_mod.confusion_and_report(
            all_true, all_pred, class_names)
        agg_dir = os.path.join(model_root, "cv_aggregate_evaluation")
        os.makedirs(agg_dir, exist_ok=True)
        np.save(os.path.join(agg_dir, "confusion_matrix.npy"), agg_cm)
        with open(os.path.join(agg_dir, "classification_report.txt"),
                  "w") as f:
            f.write(agg_report)
        with open(os.path.join(central_results_dir,
                               "aggregate_classification_report.txt"),
                  "w") as f:
            f.write(agg_report)
        print("[Aggregate] summed 5-fold CM:")
        print(agg_cm)
        print(agg_report)
        _log_cm(run, "aggregate",
                f"{stage.capitalize()} Aggregate Confusion Matrix",
                agg_cm, class_names, agg_dir)
        summary["aggregate_confusion_matrix"] = agg_cm.tolist()
        summary["aggregate"] = metrics_mod.binary_metrics(all_true, all_pred)
    return summary
