"""Patient-level aggregation of two-stage inference JSONs.

Re-implements utils/aggregate_2stage_results.py: scans *_2stage.json outputs
(skipping batch_fold* summaries, :107-110), infers ground truth from
/healthy/|/zenker/ path components (:63-72), calls a patient Zenker when
ZSR >= threshold (:75-89), and reduces TP/TN/FP/FN into accuracy, precision,
recall/sensitivity, specificity, F1, balanced accuracy (:149-168). Writes the
per-patient CSV and summary JSON contracts (:196-238).

The port's copy of the JAX package's `analysis/aggregate.py` (pure Python).
"""

from __future__ import annotations

import csv
import glob
import json
import os
from dataclasses import asdict, dataclass


@dataclass
class PatientResult:
    patient_id: str
    gt: str  # Healthy | Zenker | Unknown
    ratio: float | None
    predicted_label: str | None
    tp: int = 0
    tn: int = 0
    fp: int = 0
    fn: int = 0
    swallow_windows: int | None = None
    zenker_windows: int | None = None
    healthy_windows: int | None = None
    total_windows: int | None = None
    json_path: str = ""


def infer_ground_truth(files_used: list[str]) -> str:
    if not files_used:
        return "Unknown"
    lower = files_used[0].lower()
    if "/healthy/" in lower:
        return "Healthy"
    if "/zenker/" in lower:
        return "Zenker"
    return "Unknown"


def classify_result(gt: str, ratio: float | None, threshold: float):
    if ratio is None or gt == "Unknown":
        return None, {"tp": 0, "tn": 0, "fp": 0, "fn": 0}
    pred = "Zenker" if ratio >= threshold else "Healthy"
    cm = {"tp": 0, "tn": 0, "fp": 0, "fn": 0}
    if gt == "Healthy":
        cm["tn" if pred == "Healthy" else "fp"] = 1
    elif gt == "Zenker":
        cm["tp" if pred == "Zenker" else "fn"] = 1
    return pred, cm


def parse_patient_id(filename: str) -> str:
    base = os.path.basename(filename)
    if base.endswith("_2stage.json"):
        return base[: -len("_2stage.json")]
    return os.path.splitext(base)[0]


def aggregate_outputs(outputs_dir: str, threshold: float = 0.5,
                      csv_path: str | None = None,
                      json_path: str | None = None,
                      store_output: bool = False,
                      verbose: bool = False) -> dict:
    files = sorted(glob.glob(os.path.join(outputs_dir, "*_2stage.json")))
    results: list[PatientResult] = []
    skipped_no_ratio = skipped_unknown_gt = 0
    skipped_batch_summaries = skipped_parse_errors = 0

    for path in files:
        if os.path.basename(path).startswith("batch_fold"):
            skipped_batch_summaries += 1
            continue
        try:
            with open(path) as f:
                data = json.load(f)
        except Exception as e:
            skipped_parse_errors += 1
            if verbose:
                print(f"[WARN] Failed to read {path}: {e}")
            continue
        agg = data.get("aggregate", {})
        ratio = agg.get("overall_zenker_ratio_over_swallow")
        gt = infer_ground_truth(agg.get("files_used") or [])
        pred, cm = classify_result(gt, ratio, threshold)
        if ratio is None:
            skipped_no_ratio += 1
        if gt == "Unknown":
            skipped_unknown_gt += 1
        results.append(PatientResult(
            patient_id=parse_patient_id(path), gt=gt, ratio=ratio,
            predicted_label=pred,
            swallow_windows=agg.get("total_swallow_windows"),
            zenker_windows=agg.get("total_zenker_windows"),
            healthy_windows=agg.get("total_healthy_windows"),
            total_windows=agg.get("total_windows"),
            json_path=path, **cm))

    tp = sum(r.tp for r in results)
    tn = sum(r.tn for r in results)
    fp = sum(r.fp for r in results)
    fn = sum(r.fn for r in results)
    evaluated = tp + tn + fp + fn
    accuracy = (tp + tn) / evaluated if evaluated else 0.0
    precision = tp / (tp + fp) if (tp + fp) else None
    recall = tp / (tp + fn) if (tp + fn) else None
    specificity = tn / (tn + fp) if (tn + fp) else None
    f1 = (2 * precision * recall / (precision + recall)
          if (precision is not None and recall is not None
              and (precision + recall) > 0) else None)
    balanced = (((recall or 0.0) + (specificity or 0.0)) / 2
                if (recall is not None and specificity is not None) else None)

    summary = {
        "outputs_dir": outputs_dir,
        "threshold": threshold,
        # num_files_found keeps the reference's semantics (ALL glob matches,
        # utils/aggregate_2stage_results.py:173); the two skipped_* counters
        # below are additive so the found-vs-results gap reconciles
        "num_files_found": len(files),
        "num_patient_results": len(results),
        "skipped_batch_summaries": skipped_batch_summaries,
        "skipped_parse_errors": skipped_parse_errors,
        "skipped_no_ratio": skipped_no_ratio,
        "skipped_unknown_gt": skipped_unknown_gt,
        "confusion_matrix": {"TP": tp, "TN": tn, "FP": fp, "FN": fn},
        "metrics": {
            "accuracy": accuracy,
            "precision": precision,
            "recall_sensitivity": recall,
            "specificity": specificity,
            "f1": f1,
            "balanced_accuracy": balanced,
        },
    }
    print(json.dumps(summary, indent=2))

    default_csv = os.path.join(outputs_dir, "per_patient_results.csv")
    default_json = os.path.join(outputs_dir, "aggregate_summary.json")
    if csv_path or store_output:
        fields = list(asdict(results[0]).keys()) if results else [
            f.name for f in PatientResult.__dataclass_fields__.values()]
        with open(csv_path or default_csv, "w", newline="") as cf:
            writer = csv.DictWriter(cf, fieldnames=fields)
            writer.writeheader()
            for r in results:
                writer.writerow(asdict(r))
    if json_path or store_output:
        with open(json_path or default_json, "w") as jf:
            json.dump({"summary": summary,
                       "patients": [asdict(r) for r in results]}, jf, indent=2)
    return {"summary": summary, "patients": [asdict(r) for r in results]}
