"""Per-fold deployment-threshold extraction from ROC/PR validation metrics.

Re-implements utils/extract_thresholds_per_fold.py: pulls each fold's
best_f1_threshold (+F1/precision/recall) from the analyzer's JSON and emits
the config with string fold keys {"folds": {"1": {"stage2": {...}}}}
(+ optional stage1, + aggregate_reference) consumed by the batch driver
(src/run_batch_simple_2stage.py:97-118).

The port's copy of the JAX package's `analysis/thresholds.py` (pure Python).
"""

from __future__ import annotations

import json
import os


def extract_per_fold_thresholds(metrics_path: str) -> dict | None:
    if not os.path.exists(metrics_path):
        print(f"Error: {metrics_path} not found")
        return None
    from ..utils.fsio import load_json_object
    data = load_json_object(metrics_path, "ROC/PR metrics JSON")
    fold_reports = data.get("fold_reports", [])
    if not isinstance(fold_reports, list) or any(
            not isinstance(r, dict) for r in fold_reports):
        raise ValueError(f"ROC/PR metrics JSON {metrics_path} has a "
                         f"malformed fold_reports entry (expected a list "
                         f"of objects)")
    if not fold_reports:
        print(f"Warning: No fold_reports found in {metrics_path}")
        return None

    per_fold: dict = {}
    for report in fold_reports:
        fold = report.get("fold")
        if fold is None:
            continue
        threshold = report.get("best_f1_threshold")
        if threshold is None:
            print(f"Warning: No best_f1_threshold for fold {fold}")
            continue
        per_fold[fold] = {
            "threshold": float(threshold),
            "validation_f1": _opt(report.get("best_f1")),
            "validation_precision": _opt(report.get("best_f1_precision")),
            "validation_recall": _opt(report.get("best_f1_recall")),
        }

    aggregate = data.get("aggregate", {})
    if aggregate.get("best_f1_threshold") is not None:
        per_fold["aggregate"] = {
            "threshold": float(aggregate["best_f1_threshold"]),
            "validation_f1": float(aggregate.get("best_f1", 0)),
            "validation_precision": float(aggregate.get("best_f1_precision", 0)),
            "validation_recall": float(aggregate.get("best_f1_recall", 0)),
            "note": "Aggregate across all folds (use fold-specific thresholds instead)",
        }
    return per_fold


def _opt(v):
    return float(v) if v is not None else None


def build_threshold_config(stage2_metrics: str,
                           stage1_metrics: str | None = None,
                           output_config: str | None = None) -> dict | None:
    config = {
        "description": "Per-fold optimal thresholds from validation set ROC/PR analysis",
        "methodology": "Best F1 operating point from precision-recall curves, derived independently per fold",
        "note": "Each fold uses threshold from its own validation set only (no cross-fold contamination)",
        "folds": {},
    }
    stage2 = extract_per_fold_thresholds(stage2_metrics)
    if not stage2:
        print(f"\nERROR: Could not extract Stage 2 thresholds from {stage2_metrics}")
        return None
    stage1 = extract_per_fold_thresholds(stage1_metrics) if stage1_metrics else None

    for fold in sorted(k for k in stage2 if isinstance(k, int)):
        config["folds"][str(fold)] = {"stage2": stage2[fold]}
        if stage1 and fold in stage1:
            config["folds"][str(fold)]["stage1"] = stage1[fold]

    if "aggregate" in stage2:
        config["aggregate_reference"] = {"stage2": stage2["aggregate"]}
        if stage1 and "aggregate" in stage1:
            config["aggregate_reference"]["stage1"] = stage1["aggregate"]

    if output_config:
        with open(output_config, "w") as f:
            json.dump(config, f, indent=2)
        print(f"CONFIG SAVED: {output_config}")
    return config


def load_fold_thresholds(config_path: str, fold: int) -> dict:
    """Fold-specific {stage1: thr|None, stage2: thr|None} from a threshold
    config, matching the batch driver's lookup INCLUDING the legacy
    single-threshold fallback: when the per-fold key is absent, the flat
    {"thresholds": {"stage1": {...}, ...}} shape applies to every fold
    (src/run_batch_simple_2stage.py:97-118). The canonical implementation —
    cli/run_batch_2stage.resolve_thresholds delegates here."""
    try:
        with open(config_path) as f:
            config = json.load(f)
        fold_cfg = config.get("folds", {}).get(str(fold))
        source = fold_cfg if fold_cfg else config.get("thresholds", {})
        out = {}
        for stage in ("stage1", "stage2"):
            thr = (source or {}).get(stage, {}).get("threshold")
            out[stage] = float(thr) if thr is not None else None
        return out
    except (ValueError, TypeError, AttributeError) as e:
        # corrupt JSON / wrong shape ("folds" a list, threshold a string):
        # fail with the offending FILE named, not a bare decode traceback
        raise ValueError(
            f"corrupt or malformed threshold config {config_path!r}: "
            f"{e}") from e
