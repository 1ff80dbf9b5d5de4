"""Per-fold AST feature normalization statistics.

Re-implements utils/compute_ast_normalization_stats.py: mean/std of the
*unnormalized* padded AST features over each fold's train split
(do_normalize=False, :64-66), float64 running sum/sq-sum (:68-80), unbiased
sample variance (:85-94), and the pooled aggregate via weighted mean +
variance combination (aggregate_stats :98-113). Output contract:
stats_per_fold.json, stats_aggregate.json, stats_all.npz (:148-152).

Note: the padded rows of the (1024, 128) feature matrix are exactly 0
when unnormalized, so the per-file contribution is just the sum over the
file's real log-mel frames while the element count is always 1024*128 —
no padding is materialized. Accumulation happens in float64 on host from
f32 device frames.

The port's copy of the JAX package's `data/stats.py`: the frames come from
the port's `ops/fbank.logmel_frames` (f32, TF32 off) on the caller's
device, CUDA unless it names the CPU, length-bucketed as there.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..audio import io as aio
from ..ops import fbank as F

NUM_FOLDS = 5
SAMPLING_RATE = 16000


def compute_fold_stats(data_dir: str, fold: int, device=None) -> dict:
    """mean, std and element count of the fold's unnormalized, padded
    train features; `device` runs the log-mel (None: CUDA, which raises
    when it is missing)."""
    train_x_path = os.path.join(data_dir, f"train_x_fold{fold}.npy")
    if not os.path.exists(train_x_path):
        raise FileNotFoundError(
            f"Missing fold {fold} train data. Expected {train_x_path}")
    from ..utils import fsio
    train_x = fsio.load_npy(train_x_path, "split paths",
                            allow_pickle=True).tolist()
    if not train_x:
        return {"fold": fold, "mean": 0.0, "std": 0.0, "count": 0}

    # Featurize in batches of one clip length (length-bucketed like
    # loop._featurize_waves); the f64 sums below run on the host over the
    # f32 frames, and batching reorders them, so mean/std can drift at
    # ~1e-12 relative vs a per-file loop.
    import torch

    from ..infer.cascade import resolve_device

    device = resolve_device(device)

    running_sum = running_sq = 0.0
    total = 0

    def flush(chunk: list[np.ndarray]) -> None:
        nonlocal running_sum, running_sq, total
        n = F.num_frames(len(chunk[0]))
        if n <= 0:
            total += len(chunk) * F.MAX_FRAMES * F.NUM_MEL_BINS
            return
        k = len(chunk)
        batch = torch.from_numpy(np.stack(chunk).astype(np.float32))
        raw = F.logmel_frames(batch.to(device), n).cpu().numpy().astype(
            np.float64)[:, :F.MAX_FRAMES]
        running_sum += float(raw.sum())
        running_sq += float((raw ** 2).sum())
        total += k * F.MAX_FRAMES * F.NUM_MEL_BINS

    # stream decodes with bounded memory: at most 32 clips buffered per
    # distinct length (vs materializing the whole fold's decoded audio),
    # flushing full groups as they fill and remainders at the end
    pending: dict[int, list[np.ndarray]] = {}
    for p in train_x:
        w = aio.load_audio(str(p), SAMPLING_RATE)
        group = pending.setdefault(len(w), [])
        group.append(w)
        if len(group) == 32:
            flush(group)
            pending[len(w)] = []
    for length in sorted(pending):
        if pending[length]:
            flush(pending[length])

    if total == 0:
        return {"fold": fold, "mean": 0.0, "std": 0.0, "count": 0}
    mean = running_sum / total
    var_pop = max(running_sq / total - mean * mean, 0.0)
    var = var_pop * (total / (total - 1)) if total > 1 else 0.0
    return {"fold": fold, "mean": float(mean), "std": float(var ** 0.5),
            "count": total}


def aggregate_stats(per_fold: list[dict]) -> dict:
    total = sum(d["count"] for d in per_fold)
    if total == 0:
        return {"mean": 0.0, "std": 0.0, "total_count": 0}
    weighted_mean = sum(d["mean"] * d["count"] for d in per_fold) / total
    numerator = 0.0
    for d in per_fold:
        n = d["count"]
        if n < 2:
            continue
        numerator += (n - 1) * d["std"] ** 2 + n * (d["mean"] - weighted_mean) ** 2
    var = numerator / (total - 1) if total > 1 else 0.0
    return {"mean": float(weighted_mean), "std": float(var ** 0.5),
            "total_count": total}


def compute_all_stats(data_dir: str, output_dir: str | None = None,
                      num_folds: int = NUM_FOLDS,
                      device=None) -> tuple[list[dict], dict]:
    output_dir = output_dir or data_dir
    per_fold = []
    for fold in range(1, num_folds + 1):
        stats = compute_fold_stats(data_dir, fold, device)
        print(f"  Fold {fold}: mean={stats['mean']:.6f} "
              f"std={stats['std']:.6f} (count={stats['count']})")
        per_fold.append(stats)
    aggregate = aggregate_stats(per_fold)
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "stats_per_fold.json"), "w") as f:
        json.dump(per_fold, f, indent=2)
    with open(os.path.join(output_dir, "stats_aggregate.json"), "w") as f:
        json.dump(aggregate, f, indent=2)
    np.savez(os.path.join(output_dir, "stats_all.npz"),
             per_fold=per_fold, aggregate=aggregate)
    return per_fold, aggregate


def load_fold_normalization(data_dir: str, fold: int,
                            default_mean: float = F.DATASET_FALLBACK_MEAN,
                            default_std: float = F.DATASET_FALLBACK_STD,
                            ) -> tuple[float, float, str]:
    """3-level resolution: per-fold -> aggregate -> default, as the trainers
    do (src/train_ast_stage1_cross_validation.py:235-282). Returns
    (mean, std, source)."""
    from ..utils import fsio

    per_fold_path = os.path.join(data_dir, "stats_per_fold.json")
    if os.path.exists(per_fold_path):
        entries = fsio.load_json_value(per_fold_path, "per-fold stats")
        if not isinstance(entries, list) or any(
                not isinstance(d, dict) for d in entries):
            raise ValueError(f"per-fold stats {per_fold_path} must be a "
                             f"JSON list of per-fold objects")
        for d in entries:
            if d.get("fold") == fold and _count(d, "count",
                                                per_fold_path) > 0:
                try:
                    return float(d["mean"]), float(d["std"]), "per_fold"
                except (KeyError, TypeError, ValueError) as e:
                    raise ValueError(
                        f"per-fold stats {per_fold_path} entry for fold "
                        f"{fold} has missing or non-numeric mean/std: "
                        f"{e!r}") from e
    agg = load_aggregate_normalization(data_dir)
    if agg is not None:
        return agg[0], agg[1], "aggregate"
    return default_mean, default_std, "default"


def _count(d: dict, key: str, path: str) -> float:
    """Numeric count field, or a typed error naming the file — a string
    count would otherwise raise a bare TypeError from the `> 0` test."""
    v = d.get(key, 0)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise ValueError(f"stats file {path}: {key!r} must be numeric, "
                         f"got {v!r}")
    return float(v)


def load_aggregate_normalization(data_dir: str) -> tuple[float, float] | None:
    """(mean, std) from stats_aggregate.json, or None when the file is
    absent or records zero pooled count. Shared by the trainer fallback
    chain above and the evaluators' --use-aggregate fast path
    (analysis/snippet_eval.py) so both get the same typed errors."""
    from ..utils import fsio

    agg_path = os.path.join(data_dir, "stats_aggregate.json")
    if not os.path.exists(agg_path):
        return None
    agg = fsio.load_json_object(agg_path, "aggregate stats")
    if _count(agg, "total_count", agg_path) <= 0:
        return None
    try:
        return float(agg["mean"]), float(agg["std"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(
            f"aggregate stats {agg_path} has missing or "
            f"non-numeric mean/std: {e!r}") from e
