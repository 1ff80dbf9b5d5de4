"""ROC/PR analysis with bootstrap CIs and best-F1 operating points.

Re-implements utils/analyze_ROC_PR_stage{1,2}.py: per-fold inference on the
val split (falls back to test, load_split :116-129), ROC-AUC/PR-AUC with a
2000-resample bootstrap 95% CI (:194-220), full curve points (:268-279), the
best-F1 operating point from the PR curve (:281-291) — the source of the
deployment thresholds — plus the pooled aggregate (:316-360) and the JSON
payload {"fold_reports", "aggregate", "decision_thresholds_evaluated"}
consumed by the threshold extractor.

The port of the JAX package's `analysis/roc_pr.py`. Inference runs on the
port's AST on `device` (CUDA unless the caller names the CPU; bf16 by
default); positive-class score = softmax[:, 1]. The curve metrics are the
numpy ones of `train/metrics.py`, which equal sklearn's: no sklearn runs
here.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..train.metrics import (average_precision_score, confusion_matrix,
                             precision_recall_curve, report_dict,
                             roc_auc_score, roc_curve)

SAMPLING_RATE = 16000


def bootstrap_ci(y_true, y_scores, metric_func, n_bootstrap: int = 2000,
                 seed: int = 42) -> tuple[float, float]:
    """95% bootstrap CI, reproducing the reference's RNG sequence
    (np.random.seed + np.random.choice, :194-220)."""
    y_true = np.asarray(y_true)
    y_scores = np.asarray(y_scores)
    rng = np.random.RandomState(seed)
    n = len(y_true)
    scores = []
    for _ in range(n_bootstrap):
        idx = rng.choice(n, size=n, replace=True)
        yt, ys = y_true[idx], y_scores[idx]
        if len(np.unique(yt)) < 2:
            continue
        try:
            scores.append(metric_func(yt, ys))
        except Exception:
            continue
    return float(np.percentile(scores, 2.5)), float(np.percentile(scores, 97.5))


def load_split(data_dir: str, fold: int, preferred_split: str):
    """val falls back to test (:116-129)."""
    candidates = [preferred_split, "test"] if preferred_split == "val" else ["test"]
    for split in candidates:
        x_path = os.path.join(data_dir, f"{split}_x_fold{fold}.npy")
        y_path = os.path.join(data_dir, f"{split}_y_fold{fold}.npy")
        if os.path.exists(x_path) and os.path.exists(y_path):
            from ..utils import fsio
            X = fsio.load_npy(x_path, "split paths",
                              allow_pickle=True).tolist()
            y = np.asarray(fsio.load_npy(y_path, "split labels",
                                         allow_pickle=True),
                           dtype=int).tolist()
            return X, y, split
    raise FileNotFoundError(
        f"No {preferred_split} or test split found for fold {fold} in {data_dir}.")


def positive_scores(model_dir: str, paths, batch_size: int = 16,
                    dtype=None, device=None) -> np.ndarray:
    """softmax[:, 1] over a list of clip paths using a saved model dir."""
    from ..models import convert
    from ..train import loop as train_loop

    params, config = convert.load_hf_model_dir(model_dir)
    mean, std = train_loop.load_feature_extractor_config(model_dir)
    return positive_scores_from_params(params, config, mean, std, paths,
                                       batch_size=batch_size, dtype=dtype,
                                       device=device)


def positive_scores_from_params(params, config, mean, std, paths,
                                batch_size: int = 16, dtype=None,
                                device=None) -> np.ndarray:
    """softmax[:, 1] over clip paths from an IN-MEMORY param tree — lets
    callers score a model variant before deciding to write it to disk
    (the adapt-checkpoint ranking-drift guardrail). `device` None is
    CUDA, which raises without a card."""
    from ..infer.cascade import resolve_device
    from ..models import ast as ast_mod
    from ..train import loop as train_loop, steps

    device = resolve_device(device)
    if dtype is None:
        dtype = torch.bfloat16
    feats = train_loop.featurize_paths(paths, mean, std,
                                       max_frames=config.max_length,
                                       device=device)
    eval_step = steps.make_eval_step(config, dtype=dtype)
    # cast_params, as the engine: an int8 export's kernels column-major
    # (on the card torch._int_mm refuses a row-major one with K <= 64)
    logits = train_loop._predict(eval_step,
                                 ast_mod.cast_params(params, dtype, device),
                                 feats, batch_size, device)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True))[:, 1]


def _curve_metrics(y_true, y_scores, class_names, decision_thresholds):
    m: dict = {}
    m["roc_auc"] = float(roc_auc_score(y_true, y_scores))
    m["pr_auc"] = float(average_precision_score(y_true, y_scores))
    roc_ci = bootstrap_ci(y_true, y_scores, roc_auc_score)
    pr_ci = bootstrap_ci(y_true, y_scores, average_precision_score)
    m["roc_auc_ci_lower"], m["roc_auc_ci_upper"] = roc_ci
    m["pr_auc_ci_lower"], m["pr_auc_ci_upper"] = pr_ci

    for thr in decision_thresholds:
        preds = (np.asarray(y_scores) >= thr).astype(int)
        cm = confusion_matrix(y_true, preds, labels=[0, 1])
        report = report_dict(y_true, preds, class_names)
        m[f"thr_{thr}_confusion"] = cm.tolist()
        m[f"thr_{thr}_precision"] = report[class_names[1]]["precision"]
        m[f"thr_{thr}_recall"] = report[class_names[1]]["recall"]
        m[f"thr_{thr}_f1"] = report[class_names[1]]["f1-score"]

    fpr, tpr, roc_thr = roc_curve(y_true, y_scores)
    precision, recall, pr_thr = precision_recall_curve(y_true, y_scores)
    m["roc_curve"] = {"fpr": fpr.tolist(), "tpr": tpr.tolist(),
                      "thresholds": roc_thr.tolist()}
    m["pr_curve"] = {"precision": precision.tolist(), "recall": recall.tolist(),
                     "thresholds": pr_thr.tolist()}
    if len(pr_thr):
        f1 = (2 * precision[:-1] * recall[:-1]) / np.clip(
            precision[:-1] + recall[:-1], 1e-8, None)
        best = int(np.argmax(f1))
        m["best_f1_threshold"] = float(pr_thr[best])
        m["best_f1"] = float(f1[best])
        m["best_f1_precision"] = float(precision[best])
        m["best_f1_recall"] = float(recall[best])
    return m


def analyze(data_dir: str, model_root_template: str, *,
            stage: str = "stage1", split: str = "val",
            folds=None, batch_size: int = 16,
            decision_thresholds=(0.5,), output_json: str | None = None,
            dtype=None, device=None) -> dict:
    """Run the full per-fold + aggregate analysis; returns (and optionally
    writes) the JSON payload the threshold extractor consumes."""
    class_names = (["Idle", "Swallow"] if stage == "stage1"
                   else ["Healthy", "Zenker"])
    folds = list(folds) if folds else list(range(1, 6))

    all_true, all_scores, reports = [], [], []
    for fold in folds:
        X, y_true, used_split = load_split(data_dir, fold, split)
        model_dir = model_root_template.format(fold=fold)
        if not os.path.isdir(model_dir):
            raise FileNotFoundError(
                f"Fold {fold}: model directory missing at {model_dir}")
        y_scores = positive_scores(model_dir, X, batch_size, dtype, device)
        metrics = {"fold": fold, "split": used_split}
        metrics.update(_curve_metrics(y_true, y_scores, class_names,
                                      decision_thresholds))
        print(f"[Fold {fold}] ROC-AUC {metrics['roc_auc']:.4f} "
              f"PR-AUC {metrics['pr_auc']:.4f} best-F1-thr "
              f"{metrics.get('best_f1_threshold', float('nan')):.3f}")
        all_true.append(np.asarray(y_true))
        all_scores.append(np.asarray(y_scores))
        reports.append(metrics)

    agg = _curve_metrics(np.concatenate(all_true), np.concatenate(all_scores),
                         class_names, decision_thresholds)
    payload = {
        "fold_reports": reports,
        "aggregate": agg,
        "decision_thresholds_evaluated": list(decision_thresholds),
    }
    if output_json:
        out_dir = os.path.dirname(output_json)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        with open(output_json, "w") as f:
            json.dump(payload, f, indent=2)
        print(f"Saved analysis JSON to {output_json}")
    return payload


# ---------------------------------------------------------------------------
# Plotting (reference :387-497: combined/individual ROC + PR figures with
# dpi/format options)
# ---------------------------------------------------------------------------


def _save_fig(fig, base_path: str, dpi: int, fmt: str):
    base = os.path.splitext(base_path)[0]
    if fmt in ("png", "both"):
        fig.savefig(base + ".png", dpi=dpi, bbox_inches="tight")
        print(f"Saved plot to {base}.png")
    if fmt in ("pdf", "both"):
        fig.savefig(base + ".pdf", format="pdf", bbox_inches="tight")
        print(f"Saved plot to {base}.pdf")


def plot_payload(payload: dict, plot_dir: str, *, stage: str = "stage1",
                 combined: bool = True, individual: bool = False,
                 dpi: int = 150, fmt: str = "png") -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(plot_dir, exist_ok=True)
    reports = payload["fold_reports"]
    agg = payload["aggregate"]

    def roc_ax(ax, rep, label):
        rc = rep["roc_curve"]
        ax.plot(rc["fpr"], rc["tpr"],
                label=f"{label} (AUC={rep['roc_auc']:.3f})")

    def pr_ax(ax, rep, label):
        pc = rep["pr_curve"]
        ax.plot(pc["recall"], pc["precision"],
                label=f"{label} (AP={rep['pr_auc']:.3f})")

    if combined and len(reports) > 1:
        for kind, draw, xl, yl in (("roc", roc_ax, "False positive rate",
                                    "True positive rate"),
                                   ("pr", pr_ax, "Recall", "Precision")):
            fig, ax = plt.subplots(figsize=(6, 5))
            for rep in reports:
                draw(ax, rep, f"fold {rep['fold']}")
            draw(ax, agg, "pooled")
            if kind == "roc":
                ax.plot([0, 1], [0, 1], "k--", linewidth=0.8)
            ax.set_xlabel(xl)
            ax.set_ylabel(yl)
            ax.set_title(f"{stage} {kind.upper()} ({payload['fold_reports'][0]['split']})")
            ax.legend(fontsize=8)
            _save_fig(fig, os.path.join(plot_dir, f"{stage}_{kind}_combined"),
                      dpi, fmt)
            plt.close(fig)

    if individual:
        for rep in reports:
            fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
            roc_ax(axes[0], rep, f"fold {rep['fold']}")
            axes[0].plot([0, 1], [0, 1], "k--", linewidth=0.8)
            axes[0].set_xlabel("False positive rate")
            axes[0].set_ylabel("True positive rate")
            axes[0].legend()
            pr_ax(axes[1], rep, f"fold {rep['fold']}")
            axes[1].set_xlabel("Recall")
            axes[1].set_ylabel("Precision")
            axes[1].legend()
            fig.suptitle(f"{stage} fold {rep['fold']}")
            _save_fig(fig, os.path.join(
                plot_dir, f"{stage}_fold{rep['fold']}"), dpi, fmt)
            plt.close(fig)
