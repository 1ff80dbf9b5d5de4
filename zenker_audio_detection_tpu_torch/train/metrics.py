"""Classification metrics of the reference's compute_metrics, in numpy.

The port of the JAX package's `train/metrics.py`, which calls sklearn (HF
evaluate's accuracy/precision/recall/f1 with average="binary" wrap it). The
port computes the same numbers from the confusion counts, with no sklearn:
precision tp / (tp + fp), recall tp / (tp + fn) and F1 2 tp / (2 tp + fp +
fn), each 0 where its denominator is 0 (sklearn's `zero_division=0`), for
the positive label 1; and `classification_report` rebuilt line for line in
sklearn's layout. The ranking metrics of the ROC/PR analyzer
(`roc_curve`, `precision_recall_curve`, `roc_auc_score`,
`average_precision_score`) follow sklearn 1.9's `_binary_clf_curve`
arithmetic step for step, so their arrays equal sklearn's exactly.
"""

from __future__ import annotations

import warnings

import numpy as np


class UndefinedMetricWarning(UserWarning):
    """A metric is undefined on the data (sklearn's warning of this name)."""


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


def confusion_matrix(y_true, y_pred, labels) -> np.ndarray:
    """sklearn's `confusion_matrix(y_true, y_pred, labels=labels)`: rows
    true, columns predicted, int64 counts; samples with other labels are
    left out."""
    labels = list(labels)
    index = {lab: i for i, lab in enumerate(labels)}
    cm = np.zeros((len(labels), len(labels)), np.int64)
    for t, p in zip(np.asarray(y_true).tolist(), np.asarray(y_pred).tolist()):
        if t in index and p in index:
            cm[index[t], index[p]] += 1
    return cm


def confusion_and_report(y_true, y_pred,
                         class_names) -> tuple[np.ndarray, str]:
    """sklearn's `confusion_matrix(labels=range(C))` (rows true, columns
    predicted; samples with other labels are left out) and
    `classification_report(..., digits=4, zero_division=0)` for the labels
    0..C-1 named by `class_names`."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    labels = list(range(len(class_names)))
    cm = confusion_matrix(y_true, y_pred, labels)

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


def report_dict(y_true, y_pred, target_names) -> dict:
    """sklearn's `classification_report(y_true, y_pred,
    target_names=target_names, output_dict=True, zero_division=0)` for
    labels 0..C-1 (`report_rows`' numbers): each name maps to its
    precision, recall, f1-score and support, then "accuracy", "macro avg"
    and "weighted avg". sklearn reports the labels present in y_true or
    y_pred and raises unless they are as many as the names; here they must
    be 0..C-1."""
    present = np.unique(np.concatenate([np.asarray(y_true),
                                        np.asarray(y_pred)]))
    if present.tolist() != list(range(len(target_names))):
        raise ValueError(
            "Number of classes, {0}, does not match size of target_names, "
            "{1}. Try specifying the labels parameter".format(
                len(present), len(target_names)))
    keys = ("precision", "recall", "f1-score", "support")
    rows = [(r[0], dict(zip(keys, r[1:])))
            for r in report_rows(y_true, y_pred, target_names)]
    n = len(target_names)
    accuracy = float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))
    return {**dict(rows[:n]), "accuracy": accuracy, **dict(rows[n:])}


# ---------------------------------------------------------------------------
# Ranking metrics (sklearn 1.9's sklearn/metrics/_ranking.py, binary case)
# ---------------------------------------------------------------------------


def _binary_labels(y_true) -> tuple[np.ndarray, np.ndarray]:
    """(1-d y_true, its sorted distinct labels)."""
    y_true = np.asarray(y_true)
    if y_true.ndim != 1:
        raise ValueError(f"y should be a 1d array, got an array of shape "
                         f"{y_true.shape} instead.")
    return y_true, np.unique(y_true)


def _scores(y_score, n: int) -> np.ndarray:
    y_score = np.asarray(y_score)
    if y_score.shape != (n,):
        raise ValueError(f"Found input variables with inconsistent numbers "
                         f"of samples: [{n}, {len(y_score)}]")
    if not np.all(np.isfinite(y_score)):
        raise ValueError("Input y_score contains NaN or infinity.")
    return y_score


def _binary_clf_curve(y_true, y_score, pos_label=None):
    """(fps, tps, thresholds) at each distinct score, in decreasing score
    order: the cumulative false and true positives (float64) when every
    sample scored at least the threshold is called positive."""
    y_true, classes = _binary_labels(y_true)
    y_score = _scores(y_score, len(y_true))
    if len(classes) > 2 and pos_label is None:
        raise ValueError("multiclass format is not supported")
    if pos_label is None:
        if classes.dtype.kind in "OUS" or not any(
                len(classes) == len(ok) and np.all(classes == ok)
                for ok in ([0, 1], [-1, 1], [0], [-1], [1])):
            raise ValueError(
                "y_true takes value in {%s} and pos_label is not specified: "
                "either make y_true take value in {0, 1} or {-1, 1} or pass "
                "pos_label explicitly." % ", ".join(
                    repr(c) for c in classes.tolist()))
        pos_label = 1
    y_true = (y_true == pos_label).astype(np.int32)

    # a stable sort in decreasing score order (ties keep their order)
    n = len(y_score)
    order = n - 1 - np.argsort(y_score[::-1], kind="stable")[::-1]
    y_score = y_score[order]
    y_true = y_true[order]
    distinct = np.nonzero(np.diff(y_score))[0]
    threshold_idxs = np.concatenate([distinct, [n - 1]])
    tps = np.cumsum(y_true.astype(np.float64), dtype=np.float64)[
        threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    return fps, tps, y_score[threshold_idxs]


def roc_curve(y_true, y_score):
    """sklearn's `roc_curve`: (fpr, tpr, thresholds), float64, thresholds[0]
    = inf; collinear points dropped (sklearn's default)."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.where(np.concatenate([
            [True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)),
            [True]]))[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    if fps[-1] <= 0:
        warnings.warn("No negative samples in y_true, false positive value "
                      "should be meaningless", UndefinedMetricWarning)
        fpr = np.full(fps.shape, np.nan)
    else:
        fpr = fps / fps[-1]
    if tps[-1] <= 0:
        warnings.warn("No positive samples in y_true, true positive value "
                      "should be meaningless", UndefinedMetricWarning)
        tpr = np.full(tps.shape, np.nan)
    else:
        tpr = tps / tps[-1]
    return fpr, tpr, thresholds


def precision_recall_curve(y_true, y_score, *, pos_label=None):
    """sklearn's `precision_recall_curve`: (precision, recall, thresholds)
    with recall decreasing, a last point (1, 0) with no threshold, and the
    thresholds in y_score's dtype."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score, pos_label)
    ps = tps + fps
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(ps != 0, np.divide(tps, ps), 0.0)
    if tps[-1] == 0:
        warnings.warn("No positive class found in y_true, recall is set to "
                      "one for all thresholds.")
        recall = np.full(tps.shape, 1.0)
    else:
        recall = tps / tps[-1]
    return (np.concatenate([precision[::-1], [1.0]]),
            np.concatenate([recall[::-1], [0.0]]), thresholds[::-1])


def auc(x, y) -> float:
    """Area under the curve (x, y) by the trapezoidal rule, as sklearn's
    `auc`: x must be monotonic."""
    x = np.asarray(x)
    y = np.asarray(y)
    if x.shape[0] < 2:
        raise ValueError("At least 2 points are needed to compute area "
                         f"under curve, but x.shape = {x.shape}")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
    area = np.sum(dx * (y[1:] + y[:-1]) / 2.0,
                  dtype=np.result_type(y.dtype, np.float64))
    return float(direction * area)


def roc_auc_score(y_true, y_score) -> float:
    """sklearn's binary `roc_auc_score`: the larger label is the positive
    one; with one class present it warns and returns nan, as sklearn 1.9
    does; more than two classes raise."""
    y_true, classes = _binary_labels(y_true)
    if len(classes) > 2:
        raise ValueError("multi_class must be in ('ovo', 'ovr')")
    y_score = _scores(y_score, len(y_true))
    if len(classes) != 2:
        warnings.warn("Only one class is present in y_true. ROC AUC score "
                      "is not defined in that case.", UndefinedMetricWarning)
        return np.nan
    fpr, tpr, _ = roc_curve((y_true == classes[1]).astype(np.int64), y_score)
    return auc(fpr, tpr)


def average_precision_score(y_true, y_score) -> float:
    """sklearn's binary `average_precision_score` (positive label 1): the
    step integral -sum(diff(recall) * precision[:-1]) of the
    precision-recall curve, clipped at 0."""
    y_true, classes = _binary_labels(y_true)
    if len(classes) > 2:
        raise ValueError("average_precision_score of a 1-d y_score needs "
                         "binary y_true")
    if len(classes) == 2 and 1 not in classes.tolist():
        raise ValueError(f"pos_label=1 is not a valid label. It should be "
                         f"one of {classes}")
    precision, recall, _ = precision_recall_curve(y_true, y_score,
                                                  pos_label=1)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))
