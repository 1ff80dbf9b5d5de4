"""Classification metrics of the reference's compute_metrics, in numpy.

The port of the JAX package's `train/metrics.py`, which calls sklearn (HF
evaluate's accuracy/precision/recall/f1 with average="binary" wrap it). The
port computes the same numbers from the confusion counts, with no sklearn:
precision tp / (tp + fp), recall tp / (tp + fn) and F1 2 tp / (2 tp + fp +
fn), each 0 where its denominator is 0 (sklearn's `zero_division=0`), for
the positive label 1; and `classification_report` rebuilt line for line in
sklearn's layout.
"""

from __future__ import annotations

import numpy as np


def _divide(num, den) -> np.ndarray:
    """num / den, 0 where den is 0."""
    num = np.asarray(num, np.float64)
    den = np.asarray(den, np.float64)
    return np.where(den == 0, 0.0, num / np.where(den == 0, 1.0, den))


def _per_label(y_true, y_pred, labels):
    """(precision, recall, f1, support) per label, one-vs-rest."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    labels = np.asarray(labels)
    tp = np.array([np.sum((y_true == c) & (y_pred == c)) for c in labels])
    true_sum = np.array([np.sum(y_true == c) for c in labels])
    pred_sum = np.array([np.sum(y_pred == c) for c in labels])
    return (_divide(tp, pred_sum), _divide(tp, true_sum),
            _divide(2 * tp, true_sum + pred_sum), true_sum, tp, pred_sum)


def binary_metrics(y_true, y_pred) -> dict[str, float]:
    """accuracy, and precision, recall and f1 of the positive label 1."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    if y_true.size == 0 or y_true.shape != y_pred.shape:
        raise ValueError(f"binary_metrics needs one or more samples and "
                         f"labels of one shape, got {y_true.shape} and "
                         f"{y_pred.shape}")
    p, r, f1, _, _, _ = _per_label(y_true, y_pred, [1])
    return {
        "accuracy": float(np.mean(y_true == y_pred)),
        "precision": float(p[0]),
        "recall": float(r[0]),
        "f1": float(f1[0]),
    }


def compute_metrics_from_logits(logits, labels) -> dict[str, float]:
    return binary_metrics(labels, np.argmax(np.asarray(logits), axis=-1))


def hf_eval_metrics(logits, labels, *, loss, runtime, batch_size,
                    epoch) -> dict[str, float]:
    """A metric dict shaped like the reference trainer's
    `trainer.evaluate()` output: the compute_metrics keys prefixed with
    `eval_`, the eval loss first, the speed metrics (runtime rounded to 4
    places, rates to 3, as transformers' speed_metrics does) and the final
    `epoch` unprefixed."""
    n = int(len(labels))
    m: dict[str, float] = {"eval_loss": float(loss)}
    for k, v in compute_metrics_from_logits(logits, labels).items():
        m[f"eval_{k}"] = v
    runtime = max(float(runtime), 1e-9)
    steps = -(-n // int(batch_size)) if n else 0
    m["eval_runtime"] = round(runtime, 4)
    m["eval_samples_per_second"] = round(n / runtime, 3)
    m["eval_steps_per_second"] = round(steps / runtime, 3)
    m["epoch"] = float(epoch)
    return m


def confusion_and_report(y_true, y_pred,
                         class_names) -> tuple[np.ndarray, str]:
    """sklearn's `confusion_matrix(labels=range(C))` (rows true, columns
    predicted; samples with other labels are left out) and
    `classification_report(..., digits=4, zero_division=0)` for the labels
    0..C-1 named by `class_names`."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    labels = list(range(len(class_names)))
    cm = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(y_true, y_pred):
        if t in labels and p in labels:
            cm[t, p] += 1

    p, r, f1, support, tp, pred_sum = _per_label(y_true, y_pred, labels)
    digits = 4
    width = max(max(len(cn) for cn in class_names), len("weighted avg"),
                digits)
    headers = ["precision", "recall", "f1-score", "support"]
    report = ("{:>{width}s} " + " {:>9}" * len(headers)).format(
        "", *headers, width=width) + "\n\n"
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    for row in zip(class_names, p, r, f1, support):
        report += row_fmt.format(*row, width=width, digits=digits)
    report += "\n"

    total = int(np.sum(support))
    # micro average: it is the accuracy when every label in the data is one
    # of `labels` (sklearn then prints it as "accuracy")
    present = set(np.unique(np.concatenate([y_true, y_pred])).tolist())
    micro_p = _divide(tp.sum(), pred_sum.sum())
    micro_r = _divide(tp.sum(), support.sum())
    micro_f1 = _divide(2 * tp.sum(), support.sum() + pred_sum.sum())
    if present <= set(labels):
        report += ("{:>{width}s} " + " {:>9.{digits}}" * 2
                   + " {:>9.{digits}f}" + " {:>9}\n").format(
            "accuracy", "", "", micro_f1, total, width=width, digits=digits)
    else:
        report += row_fmt.format("micro avg", micro_p, micro_r, micro_f1,
                                 total, width=width, digits=digits)
    report += row_fmt.format("macro avg", np.mean(p), np.mean(r), np.mean(f1),
                             total, width=width, digits=digits)
    if support.sum() == 0:
        weighted = (0.0, 0.0, 0.0)
    else:
        weighted = tuple(np.average(x, weights=support) for x in (p, r, f1))
    report += row_fmt.format("weighted avg", *weighted, total, width=width,
                             digits=digits)
    return cm, report


def report_rows(y_true, y_pred, class_names) -> list[list]:
    """The rows of sklearn's `classification_report(..., labels=range(C),
    output_dict=True, zero_division=0)` that hold a precision, as the JAX
    trainer logs them into its report table: [name, precision, recall,
    f1-score, support] for each class, then "macro avg" and "weighted avg"
    (the accuracy entry is a bare number there, so it has no row; with a
    label outside 0..C-1 in the data sklearn adds "micro avg" first)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    labels = list(range(len(class_names)))
    p, r, f1, support, tp, pred_sum = _per_label(y_true, y_pred, labels)
    rows = [[name, float(p[i]), float(r[i]), float(f1[i]), int(support[i])]
            for i, name in enumerate(class_names)]
    total = int(np.sum(support))
    present = set(np.unique(np.concatenate([y_true, y_pred])).tolist())
    if not present <= set(labels):
        rows.append(["micro avg", float(_divide(tp.sum(), pred_sum.sum())),
                     float(_divide(tp.sum(), support.sum())),
                     float(_divide(2 * tp.sum(),
                                   support.sum() + pred_sum.sum())), total])
    rows.append(["macro avg", float(np.mean(p)), float(np.mean(r)),
                 float(np.mean(f1)), total])
    if support.sum() == 0:
        weighted = (0.0, 0.0, 0.0)
    else:
        weighted = tuple(float(np.average(x, weights=support))
                         for x in (p, r, f1))
    rows.append(["weighted avg", *weighted, total])
    return rows
