"""Publication-style confusion-matrix plots with precision/recall overlay.

Re-implements utils/plot_confusion_matrices.py: seaborn heatmap with the
masked overlay technique (:16-99), loading summed 5-fold CMs from
`<model_root>/ast_classifier_<stage>/cv_aggregate_evaluation/confusion_matrix.npy`
(:102-125) with the paper's hardcoded CMs as fallback (:168-184), plus the
derived accuracy/recall/precision printout (:204-219).

The port's copy of the JAX package's `analysis/cm_plots.py` (numpy, with
matplotlib and seaborn imported where a plot is drawn).
"""

from __future__ import annotations

import os

import numpy as np

# The paper's summed 5-fold confusion matrices (reference fallback values —
# also the quality baseline in BASELINE.md).
PAPER_CM_STAGE1 = np.array([[2590, 229], [108, 1324]])
PAPER_CM_STAGE2 = np.array([[473, 261], [117, 581]])


def plot_confusion_matrix_overlay(cm, class_names, title, output_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import seaborn as sns
    from matplotlib.colors import ListedColormap

    cm = np.asarray(cm, dtype=float)
    total = cm.sum()
    labels = [[f"{v:0.0f}\n{v / total:.1%}" for v in row] for row in cm]

    fig, ax = plt.subplots(figsize=(9, 8))
    sns.heatmap(cm, annot=labels, cmap="Blues", fmt="",
                xticklabels=class_names, yticklabels=class_names,
                cbar=False, linewidths=1, linecolor="black", ax=ax,
                annot_kws={"fontsize": 20, "fontweight": "bold"})
    ax.set_xlabel("Predicted Class", fontweight="bold", fontsize=16)
    ax.set_ylabel("True Class", fontweight="bold", fontsize=16)
    ax.set_title(title, fontweight="bold", fontsize=18, pad=20)
    ax.tick_params(labeltop=False, labelbottom=True, labelsize=14, length=0)

    def safe_div(num, den):
        den = np.asarray(den, dtype=float)
        return np.divide(num, den, out=np.zeros_like(den),
                         where=den != 0)  # empty class -> 0, not NaN

    f_mat = np.zeros((cm.shape[0] + 1, cm.shape[1] + 1))
    f_mat[:-1, -1] = safe_div(np.diag(cm), cm.sum(axis=1))  # recall column
    f_mat[-1, :-1] = safe_div(np.diag(cm), cm.sum(axis=0))  # precision row
    f_mat[-1, -1] = np.trace(cm) / max(total, 1)             # accuracy corner
    f_mask = np.ones_like(f_mat)
    f_mask[:, -1] = 0
    f_mask[-1, :] = 0
    f_color = np.ones_like(f_mat)
    f_color[-1, -1] = 0
    f_annot = [[f"{v:0.1%}" for v in row] for row in f_mat]
    f_annot[-1][-1] = f"Acc:\n{f_mat[-1, -1]:0.1%}"
    sns.heatmap(f_color, mask=f_mask, annot=f_annot, fmt="",
                xticklabels=list(class_names) + ["Recall"],
                yticklabels=list(class_names) + ["Precision"],
                cmap=ListedColormap(["lightblue", "lightgrey"]),
                cbar=False, ax=ax, linewidths=2, linecolor="black",
                annot_kws={"fontsize": 16, "fontweight": "bold"})
    plt.tight_layout()
    plt.savefig(output_path, dpi=300, facecolor="white")
    plt.savefig(os.path.splitext(output_path)[0] + ".pdf", facecolor="white")
    plt.close(fig)
    print(f"Saved confusion matrix to {output_path}")


def load_confusion_matrix_from_results(stage: str, model_root: str) -> np.ndarray | None:
    cm_path = os.path.join(model_root, f"ast_classifier_{stage}",
                           "cv_aggregate_evaluation", "confusion_matrix.npy")
    if not os.path.exists(cm_path):
        return None
    from ..utils.fsio import load_npy
    return load_npy(cm_path, "confusion-matrix file")


def derived_stats(cm: np.ndarray) -> dict[str, float]:
    cm = np.asarray(cm, dtype=float)

    def div(num, den):  # empty class/CM -> 0.0, like the overlay's guard
        return float(num / den) if den else 0.0

    return {
        "total": float(cm.sum()),
        "accuracy": div(cm[0, 0] + cm[1, 1], cm.sum()),
        "positive_recall": div(cm[1, 1], cm[1, :].sum()),
        "positive_precision": div(cm[1, 1], cm[:, 1].sum()),
    }


def plot_both_stages(model_root: str, output_dir: str | None = None) -> dict:
    output_dir = output_dir or os.path.join(model_root, "results")
    os.makedirs(output_dir, exist_ok=True)

    cms = {}
    for stage, names, fallback in (
            ("stage1", ["Idle", "Swallow"], PAPER_CM_STAGE1),
            ("stage2", ["Healthy", "Zenker"], PAPER_CM_STAGE2)):
        cm = load_confusion_matrix_from_results(stage, model_root)
        if cm is None:
            print(f"Using hardcoded {stage} confusion matrix")
            cm = fallback
        title = (f"Summed 5-Fold Confusion Matrix: "
                 f"{'Stage 1 (Idle vs. Swallow)' if stage == 'stage1' else 'Stage 2 (Healthy vs. Zenker)'}")
        plot_confusion_matrix_overlay(
            cm, names, title,
            os.path.join(output_dir, f"{stage}_confusion_matrix_clean.png"))
        stats = derived_stats(cm)
        pos = names[1]
        print(f"\n{stage}: total={stats['total']:.0f} "
              f"accuracy={stats['accuracy'] * 100:.2f}% "
              f"{pos} recall={stats['positive_recall'] * 100:.2f}% "
              f"{pos} precision={stats['positive_precision'] * 100:.2f}%")
        cms[stage] = cm
    return cms
