"""The study's two-stage gate and per-patient summary, on window
probabilities.

Windows: 1 s every 0.5 s, full windows only (one zero-padded window for a
file shorter than 1 s). Gate: a window goes to stage 2 when stage 1's
argmax is Swallow and its Swallow probability is at least the threshold.
Summary: stage-1 counts by the raw argmax, stage-2 counts over the gated
windows by the stage-2 threshold, the ratios and means of each file, and
the patient's totals over its files.
"""

from __future__ import annotations

import numpy as np


def window_starts(samples: int, window: int, hop: int) -> np.ndarray:
    return np.arange(0, max(1, samples - window + 1), hop, dtype=np.int64)


def gate(p1: np.ndarray, threshold: float) -> np.ndarray:
    """Indices of the windows forwarded to stage 2."""
    return np.flatnonzero((p1.argmax(1) == 1) & (p1[:, 1] >= threshold))


def file_summary(p1: np.ndarray, p2: np.ndarray, threshold1: float,
                 threshold2: float) -> dict:
    idx = gate(p1, threshold1)
    evaluated = p2[idx]
    swallow = int((p1.argmax(1) == 1).sum())
    zenker = int((evaluated[:, 1] >= threshold2).sum())
    W = len(p1)
    return {
        "num_windows": W,
        "stage1_idle_windows": W - swallow,
        "stage1_swallow_windows": swallow,
        "stage1_swallow_ratio": swallow / W if W else 0.0,
        "stage1_mean_probs": p1.mean(0).tolist() if W else None,
        "stage2_mean_probs_over_swallow":
            evaluated.mean(0).tolist() if swallow else None,
        "stage2_swallow_windows_evaluated": len(idx),
        "stage2_healthy_windows": len(idx) - zenker,
        "stage2_zenker_windows": zenker,
        "stage2_zenker_ratio_over_swallow":
            zenker / swallow if swallow else None,
    }


def patient_totals(files: list[dict]) -> dict:
    total = sum(f["num_windows"] for f in files)
    swallow = sum(f["stage1_swallow_windows"] for f in files)
    zenker = sum(f["stage2_zenker_windows"] for f in files)
    return {
        "total_windows": total,
        "total_idle_windows": sum(f["stage1_idle_windows"] for f in files),
        "total_swallow_windows": swallow,
        "total_swallow_ratio": swallow / max(1, total),
        "total_swallow_windows_evaluated_stage2":
            sum(f["stage2_swallow_windows_evaluated"] for f in files),
        "total_healthy_windows":
            sum(f["stage2_healthy_windows"] for f in files),
        "total_zenker_windows": zenker,
        "overall_zenker_ratio_over_swallow":
            zenker / swallow if swallow else None,
    }


def mismatches(got: dict, want: dict, rel: float = 1e-9) -> list[str]:
    """The keys of `want` whose value `got` does not hold: numbers within
    `rel` (sums taken in another order), everything else equal."""
    bad = []
    for key, w in want.items():
        g = got.get(key)
        if isinstance(w, list) and isinstance(g, list) and len(w) == len(g):
            ok = all(abs(a - b) <= rel * max(1.0, abs(b)) for a, b in zip(g, w))
        elif isinstance(w, float) and isinstance(g, (int, float)):
            ok = abs(g - w) <= rel * max(1.0, abs(w))
        else:
            ok = g == w
        if not ok:
            bad.append(key)
    return bad
