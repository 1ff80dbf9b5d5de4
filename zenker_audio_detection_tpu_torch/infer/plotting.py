"""Waveform overlay plots for two-stage inference results
(src/test_long_audio_windows_2stage.py:412-522): one subplot per file,
Healthy/Zenker shading over predicted-swallow windows, GT extracted from the
path, Z/Sw ratio in the title, PNG+PDF output.

The port's copy of the JAX package's `infer/plotting.py` (matplotlib and numpy only).
"""

from __future__ import annotations

import os

import numpy as np

SAMPLING_RATE = 16000

_HEALTHY = "#a4e5a4"
_ZENKER = "#f5a3a3"
_SWALLOW_ONLY = "#ffd27f"


def ground_truth_from_path(path: str) -> str:
    lower = path.lower()
    if "zenker" in lower:
        return "Zenker"
    if "healthy" in lower:
        return "Healthy"
    return "Unknown"


def plot_two_stage(plot_assets, window_sec: float, hop_sec: float,
                   plot_dir: str, patient_id: str | None = None,
                   cached_name: bool = False) -> str:
    """plot_assets: list of (audio, s1_preds, stage2_aligned_classes, label,
    path) per file. Returns the PNG path.

    cached_name selects the cache-variant script's artifact names
    (`{pid}_2stage_plot_cached.{png,pdf}`,
    src/test_long_audio_windows_2stage_cache.py:693-694) over the base
    script's (`{pid}_2stage_plot.*`, …_2stage.py:515-516). The reference
    batch driver and all-folds wrapper always invoke the cache variant
    (run_batch_simple_2stage.py SCRIPT_NAME), so our batch paths pass
    True; the direct infer CLI presents the base script's surface."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Patch

    os.makedirs(plot_dir, exist_ok=True)
    plt.rcParams.update({
        "font.size": 14, "axes.titlesize": 16, "axes.labelsize": 14,
        "xtick.labelsize": 12, "ytick.labelsize": 12, "legend.fontsize": 12,
    })
    fig, axes = plt.subplots(len(plot_assets), 1,
                             figsize=(14, 4 * len(plot_assets)), sharex=False)
    if len(plot_assets) == 1:
        axes = [axes]

    for ax, (audio, s1_preds, s2_classes, label, path) in zip(axes, plot_assets):
        duration = len(audio) / SAMPLING_RATE
        t = np.linspace(0, duration, len(audio))
        ax.plot(t, audio, color="blue", linewidth=0.6)
        ax.set_ylabel("Amplitude")
        for w_idx, cls1 in enumerate(s1_preds):
            if cls1 == 0:
                continue
            start_t = w_idx * hop_sec
            end_t = min(start_t + window_sec, duration)
            cls2 = s2_classes[w_idx]
            color = {0: _HEALTHY, 1: _ZENKER}.get(int(cls2), _SWALLOW_ONLY)
            ax.axvspan(start_t, end_t, color=color, alpha=0.35, linewidth=0)
        ax.set_xlim(0, duration)

        num_healthy = int(np.sum(np.asarray(s2_classes) == 0))
        num_zenker = int(np.sum(np.asarray(s2_classes) == 1))
        num_swallow = int(np.sum(np.asarray(s1_preds) == 1))
        if num_swallow > 0:
            ratio_str = f", Ratio Z/Sw: {num_zenker / num_swallow:.2f}"
        else:
            ratio_str = ", Ratio: N/A" if num_zenker > 0 else ""
        ax.set_title(f"{label}: {os.path.basename(path)} "
                     f"[GT: {ground_truth_from_path(path)}] | Detected: "
                     f"{num_healthy} Healthy, {num_zenker} Zenker{ratio_str}")

    axes[-1].set_xlabel("Time (s)")
    axes[0].legend(handles=[
        Patch(facecolor=_HEALTHY, edgecolor="none", alpha=0.35,
              label="Swallow→Healthy"),
        Patch(facecolor=_ZENKER, edgecolor="none", alpha=0.35,
              label="Swallow→Zenker"),
    ], loc="upper right")

    base_id = patient_id or "pair"
    stem = f"{base_id}_2stage_plot_cached" if cached_name \
        else f"{base_id}_2stage_plot"
    png = os.path.join(plot_dir, f"{stem}.png")
    pdf = os.path.join(plot_dir, f"{stem}.pdf")
    fig.tight_layout()
    fig.savefig(png, dpi=150)
    fig.savefig(pdf, format="pdf", bbox_inches="tight")
    plt.close(fig)
    print(f"Saved plot: {png}")
    return png
