"""Fine-tuning loop: the HF-Trainer-equivalent of the port.

The port of the JAX package's `train/loop.py`, which replicates the
training behaviour of the reference's per-fold pipeline
(src/train_ast_stage1_cross_validation.py:417-645 and the stage-2 twin):

  run-dir backup -> per-fold normalization -> pretrained load + 2-class head
  re-init -> eager dataset featurization (augment train split once, like the
  reference's `datasets.map`) -> epoch loop (batch 16, eval+checkpoint per
  epoch, best-on-F1, early stop patience 2 / threshold 0.001 when a val
  split exists) -> export `fold{k}/best/` as an HF model dir (+ feature
  extractor config so the deployed mean/std travels with the model) ->
  val/test confusion matrices -> cross-fold mean/std aggregation
  (cv_metrics.npy/.txt).

The names and semantics are the JAX module's. The loop runs on one device,
`TrainFoldConfig.device`: CUDA unless the caller names the CPU, and it
raises when CUDA is asked for and missing. The log-mel runs there in f32
with TF32 off (`ops/fbank.logmel_frames`). The train step
(`train/steps.py`, no route named) runs the Hopper attention kernels
forward and backward when it trains in bf16 on a CUDA device at a head
width they take, the port of the JAX trainer's "pallas" route; elsewhere,
and in the eval step everywhere, it runs the model's "torch" attention, as
the JAX trainer's steps run their default "xla" attention. On the card
the kernels take a bf16 step at the AST's full width to about a third of
the "torch" route's time. `fold_parallel` trains all folds at once in one
vmapped step on that device (train/fold_parallel.py), on the "torch"
attention, which runs under vmap.

Over several devices (`num_devices`, `num_slices`; parallel/mesh.py) the
loop runs in every rank of a process group (parallel/launch.py starts
them): each rank draws the global batch from the same seeds, as the single
process does, and the step shards its rows (train/steps.py); parameters
and optimizer state are replicated, evaluation chunks are sharded and
their logits gathered, so every rank computes the same metrics and takes
the same early-stopping and best-model branches. The first rank writes
every file (run dirs, checkpoints, exports), the others wait for it at a
barrier.

Checkpoints keep the JAX layout (`save_checkpoint`), so a JAX checkpoint
of the sequential trainer resumes here too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import time
from datetime import datetime
from typing import Any

import numpy as np
import torch

from ..audio import io as aio
from ..data import augment as aug
from ..data import stats as stats_mod
from ..infer.cascade import resolve_device
from ..models import ast as ast_mod
from ..models import convert
from ..ops import fbank as F
from ..parallel import mesh as pmesh
from ..utils import fsio, prng
from . import losses, metrics as metrics_mod, optim, steps

SAMPLING_RATE = 16000
NUM_EPOCHS = 10
SEED = 42

STAGE_LABELS = {
    "stage1": ["Idle", "Swallow"],
    "stage2": ["Healthy", "Zenker"],
}


@dataclasses.dataclass
class TrainFoldConfig:
    stage: str = "stage1"
    data_dir: str = "data_ast_stage1"
    output_root: str = "runs/ast_classifier_stage1"
    pretrained_model_dir: str | None = None  # HF dir; None -> random init
    num_epochs: int = NUM_EPOCHS
    batch_size: int = 16
    eval_batch_size: int = 8
    learning_rate: float = 5e-5
    weight_decay: float = 0.01
    warmup_ratio: float = 0.1
    adam_beta2: float = 0.98
    focal_gamma: float = 0.0
    label_smoothing: float = 0.0
    # stage2 extras (ImprovedWeightedTrainer)
    use_class_weights: bool = False
    focal_alpha: float | None = 0.25
    use_focal_loss: bool = True
    enable_early_stopping: bool = True
    early_stopping_patience: int = 2
    early_stopping_threshold: float = 0.001
    augment: bool = True
    dry_run: bool = False
    seed: int = SEED
    dtype: torch.dtype = torch.bfloat16
    # the device of the whole loop: featurization, steps, evaluation.
    # "cuda" (or "cuda:N") raises when CUDA is missing; the CPU only when
    # named
    device: str = "cuda"
    # resume from the latest checkpoint-* in the fold dir (params, optimizer
    # state, RNG, best-model tracking all restored)
    resume: bool = False
    # optional hook: on_epoch_end(epoch, metrics_dict) -> True to stop early
    # (used by the sweep agent's Hyperband-style early termination)
    on_epoch_end: Any = None
    # data-parallel mesh size (parallel/mesh.py): params/opt-state
    # replicated, batch rows sharded over a 1-D "data" mesh of ranks.
    # None/1 = single device.
    num_devices: int | None = None
    # split num_devices into this many slices: a hierarchical ("dcn",
    # "data") mesh, each slice's ranks contiguous
    num_slices: int | None = None
    # short-sequence mode: fine-tune at this input frame count instead of
    # the checkpoint's (models/ast.py adapt_max_length); None = keep the
    # checkpoint's length
    max_length: int | None = None
    # stream the train split per batch (O(batch) host memory + background
    # prefetch) instead of eager whole-split featurization; numerics are
    # identical (FeatureStream docstring)
    streaming: bool = False
    # per-step train-loss logging cadence into the tracker (the reference's
    # HF Trainer logging_steps=20); 0 disables
    logging_steps: int = 20
    # train all folds at once in one vmapped step (train/fold_parallel.py),
    # the fold axis split over num_devices; data_per_fold gives each fold a
    # group of that many devices sharing its batch rows (a 2-D ("fold",
    # "data") mesh). None/1 = the flat 1-D fold mesh.
    fold_parallel: bool = False
    data_per_fold: int | None = None
    # accumulate this many micro-batches of batch_size before each
    # optimizer update; the LR schedule counts OPTIMIZER steps. 1 = the
    # parity path (batch 16, one update per batch, reference :484).
    grad_accum: int = 1


def backup_existing_run_dir(path: str) -> str | None:
    """Timestamped copy of a non-empty run dir before overwrite
    (src/train_ast_stage1_cross_validation.py:188-232)."""
    if not os.path.isdir(path) or not any(os.scandir(path)):
        return None
    try:
        ts = datetime.fromtimestamp(os.stat(path).st_mtime)
    except OSError:
        ts = datetime.now()
    base = f"{os.path.normpath(path)}_{ts.strftime('%Y%m%d_%H%M%S')}"
    backup = base
    counter = 1
    while os.path.exists(backup):
        backup = f"{base}_{counter}"
        counter += 1
    print(f"[RunBackup] Existing run dir detected; copying '{path}' -> '{backup}'")
    shutil.copytree(path, backup)
    return backup


# ---------------------------------------------------------------------------
# Featurization (device-batched replacement for the eager datasets.map)
# ---------------------------------------------------------------------------


def to_waveform(entry) -> np.ndarray:
    """Audio payload -> 16 kHz float32 waveform. Accepts a path, an ndarray
    (assumed 16 kHz), or a dict {"array"/"audio"/"values", "sampling_rate"}
    — the reference analyzer's payload contract
    (utils/analyze_ROC_PR_stage1.py:132-155). int16 payloads are PCM and
    scaled by 1/32768, matching ops/fbank.logmel_frames' device-side
    convention (everything else is assumed already float-scaled)."""
    if isinstance(entry, np.ndarray):
        if entry.dtype == np.int16:
            return entry.astype(np.float32) * (1.0 / 32768.0)
        return entry.astype(np.float32)
    if isinstance(entry, dict):
        arr = entry.get("array")
        if arr is None:
            arr = entry.get("audio")
        if arr is None:
            arr = entry.get("values")
        if arr is None:
            raise ValueError("Unsupported dict payload for audio sample.")
        arr = np.asarray(arr)
        if arr.dtype == np.int16:
            arr = arr.astype(np.float32) * (1.0 / 32768.0)
        else:
            arr = arr.astype(np.float32)
        sr = (entry.get("sampling_rate") or entry.get("sampling_rate_hz")
              or SAMPLING_RATE)
        if sr != SAMPLING_RATE:
            from ..ops import resample as R

            arr = R.resample(arr, int(sr), SAMPLING_RATE)
        return arr
    if isinstance(entry, (str, os.PathLike)):
        return aio.load_audio(str(entry), SAMPLING_RATE)
    raise TypeError(f"Unsupported audio payload type: {type(entry)}")


def _spawn_example_rngs(augment_rng, n: int) -> list:
    """Independent per-example generators (SeedSequence spawn): results
    don't depend on worker scheduling, and the SAME seed yields the SAME
    augmentation per example whether featurized eagerly or streamed."""
    if augment_rng is None:
        return [None] * n
    seeds = augment_rng.bit_generator.seed_seq.spawn(n)
    return [np.random.default_rng(s) for s in seeds]


def _featurize_waves(waves, mean: float, std: float, max_frames: int,
                     batch: int, device: torch.device) -> np.ndarray:
    """Decoded waveforms -> (N, max_frames, 128) normalized features on the
    host; the log-mel runs on `device` in f32 with TF32 off, batched by
    length."""
    out = np.empty((len(waves), max_frames, F.NUM_MEL_BINS), np.float32)
    denom = 2.0 * std
    pad_value = (0.0 - mean) / denom  # HF pads raw fbank, then normalizes
    out[:] = pad_value

    by_len: dict[int, list[int]] = {}
    for i, w in enumerate(waves):
        by_len.setdefault(len(w), []).append(i)
    for length, idxs in by_len.items():
        n_frames = min(F.num_frames(length), max_frames)
        if n_frames <= 0:  # sub-frame clip: all-pad features
            continue
        for s in range(0, len(idxs), batch):
            chunk = idxs[s: s + batch]
            stackw = torch.from_numpy(
                np.stack([waves[i] for i in chunk]).astype(np.float32))
            raw = F.logmel_frames(stackw.to(device),
                                  F.num_frames(length)).cpu().numpy()
            out[chunk, :n_frames] = (raw[:, :n_frames] - mean) / denom
    return out


def _decode_entries(entries, ex_rngs, workers: int | None = None) -> list:
    """Decode (+augment) entries on a host thread pool (the reference's CPU
    hot loops #1/#2, SURVEY §3.1, parallelized)."""
    from concurrent.futures import ThreadPoolExecutor

    def prepare(i):
        w = to_waveform(entries[i])
        if ex_rngs[i] is not None:
            w = aug.augment_waveform(w, ex_rngs[i])
        return w

    workers = workers or min(16, os.cpu_count() or 4)
    if len(entries) > 1 and workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(prepare, range(len(entries))))
    return [prepare(i) for i in range(len(entries))]


def featurize_paths(paths, mean: float, std: float,
                    augment_rng: np.random.Generator | None = None,
                    batch: int = 32, workers: int | None = None,
                    max_frames: int = F.MAX_FRAMES,
                    device=None) -> np.ndarray:
    """Decode -> (augment) -> fbank+normalize the WHOLE split eagerly.
    Entries may be paths, ndarrays, or dict payloads (see to_waveform);
    the log-mel runs on `device` (None: CUDA).

    Memory ceiling (like the reference's eager `datasets.map`): the split is
    materialized as (N, max_frames, 128) float32 on host — 512 KB/clip at
    1024 frames, ~5 GB at 10k clips. For larger corpora use FeatureStream
    (TrainFoldConfig.streaming), which featurizes per batch with identical
    numerics."""
    device = resolve_device(device)
    ex_rngs = _spawn_example_rngs(augment_rng, len(paths))
    waves = _decode_entries(paths, ex_rngs, workers)
    return _featurize_waves(waves, mean, std, max_frames, batch, device)


class FeatureStream:
    """Lazy, O(batch)-memory featurization with background prefetch.

    Identical numerics to `featurize_paths`: per-example augmentation
    generators are spawned once up front, so `gather(idx)` returns the same
    features eager featurization would have put at those rows, regardless
    of batch composition or epoch order. `prefetch(idx)` overlaps the next
    batch's host decode/augment/fbank with the current device step."""

    def __init__(self, entries, mean: float, std: float,
                 augment_rng: np.random.Generator | None = None,
                 max_frames: int = F.MAX_FRAMES, batch: int = 32,
                 device=None):
        from concurrent.futures import ThreadPoolExecutor

        self._entries = list(entries)
        self._mean, self._std = mean, std
        self._max_frames, self._batch = max_frames, batch
        self._device = resolve_device(device)
        # store SEEDS, not generators: a fresh generator per gather makes
        # every epoch's features identical to each other and to the eager
        # path (the reference augments once at map time, SURVEY §3.1)
        self._seeds = (augment_rng.bit_generator.seed_seq.spawn(
            len(self._entries)) if augment_rng is not None
            else [None] * len(self._entries))
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: tuple | None = None  # (key, future)

    def __len__(self):
        return len(self._entries)

    def _compute(self, idx) -> np.ndarray:
        rngs = [np.random.default_rng(self._seeds[i])
                if self._seeds[i] is not None else None for i in idx]
        waves = _decode_entries([self._entries[i] for i in idx], rngs)
        return _featurize_waves(waves, self._mean, self._std,
                                self._max_frames, self._batch, self._device)

    def prefetch(self, idx) -> None:
        idx = np.asarray(idx)
        self._pending = (idx.tobytes(), self._pool.submit(self._compute, idx))

    def gather(self, idx) -> np.ndarray:
        idx = np.asarray(idx)
        if self._pending is not None and self._pending[0] == idx.tobytes():
            fut = self._pending[1]
            self._pending = None
            return fut.result()
        self._pending = None
        return self._compute(idx)

    def close(self):
        self._pool.shutdown(wait=False)


def _load_split(data_dir, split, fold):
    x_path = os.path.join(data_dir, f"{split}_x_fold{fold}.npy")
    y_path = os.path.join(data_dir, f"{split}_y_fold{fold}.npy")
    if not (os.path.exists(x_path) and os.path.exists(y_path)):
        return None, None
    x = fsio.load_npy(x_path, "split paths", allow_pickle=True).tolist()
    y = np.asarray(fsio.load_npy(y_path, "split labels", allow_pickle=True),
                   dtype=np.int32)
    return x, y


def save_feature_extractor_config(path: str, mean: float, std: float,
                                  max_length: int = F.MAX_FRAMES) -> None:
    """preprocessor_config.json compatible with ASTFeatureExtractor."""
    with open(os.path.join(path, "preprocessor_config.json"), "w") as f:
        json.dump({
            "feature_extractor_type": "ASTFeatureExtractor",
            "feature_size": 1,
            "sampling_rate": SAMPLING_RATE,
            "num_mel_bins": F.NUM_MEL_BINS,
            "max_length": max_length,
            "padding_side": "right",
            "padding_value": 0.0,
            "return_attention_mask": False,
            "do_normalize": True,
            "mean": float(mean),
            "std": float(std),
        }, f, indent=2)


def load_feature_extractor_config(model_dir: str) -> tuple[float, float]:
    p = os.path.join(model_dir, "preprocessor_config.json")
    d = fsio.load_json_object(p, "feature-extractor config")
    try:
        return float(d["mean"]), float(d["std"])
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"feature-extractor config {p} has missing or "
                         f"non-numeric mean/std: {e!r}") from e


# ---------------------------------------------------------------------------
# The fold trainer
# ---------------------------------------------------------------------------


def _make_loss(cfg: TrainFoldConfig, class_weights):
    if cfg.stage == "stage1":
        def loss(logits, labels):
            return losses.stage1_loss(logits, labels, cfg.focal_gamma,
                                      cfg.label_smoothing)
    elif cfg.use_focal_loss:
        def loss(logits, labels):
            return losses.stage2_focal_loss(
                logits, labels, class_weights, cfg.focal_alpha,
                cfg.focal_gamma, cfg.label_smoothing)
    else:
        def loss(logits, labels):
            return losses.stage2_weighted_ce(logits, labels, class_weights,
                                             cfg.label_smoothing)
    return loss


def _predict(eval_step, params, feats, batch: int,
             device: torch.device, mesh=None) -> np.ndarray:
    """f32 logits of `feats` (host numpy) in chunks of `batch` on `device`;
    the tail chunk runs at its own size (each row's logits do not depend on
    the others). With `mesh` the chunks stay on the host and the mesh's
    eval step moves each rank's rows (steps.make_eval_step)."""
    outs = []
    for s in range(0, len(feats), batch):
        chunk = torch.from_numpy(np.ascontiguousarray(feats[s: s + batch]))
        if mesh is None:
            chunk = chunk.to(device)
        outs.append(eval_step(params, chunk).cpu().numpy())
    return np.concatenate(outs) if outs else np.zeros((0, 2), np.float32)


def _to_host(params):
    """A host copy of `params` (the JAX loop's `jax.tree.map(np.asarray,
    ...)`): the tensors of the best or the current weights, detached."""
    return optim.tree_map(lambda t: t.detach().cpu(), params)


def _to_device(params, device: torch.device):
    return optim.tree_map(lambda t: t.detach().to(device), params)


def _writer(mesh) -> bool:
    """Whether this rank writes the files: always without a mesh, else the
    mesh's first rank."""
    if mesh is None:
        return True
    return pmesh.is_main(mesh)


def _barrier(mesh) -> None:
    """The mesh's ranks wait for its writer's files."""
    if mesh is not None:
        pmesh.barrier(mesh)


def prepare_fold_dir(fold: int, cfg: TrainFoldConfig, mesh=None
                     ) -> tuple[str, float, float]:
    """Run-dir backup + normalization-stat resolution (reference :433-443,
    :235-282). With `mesh` its first rank backs up and clears the dir."""
    fold_dir = os.path.join(cfg.output_root, f"fold{fold}")
    if (_writer(mesh) and not cfg.resume
            and backup_existing_run_dir(fold_dir)):
        shutil.rmtree(fold_dir)
        print(f"[RunBackup] Cleared original run dir '{fold_dir}' after backup.")
    _barrier(mesh)
    os.makedirs(fold_dir, exist_ok=True)
    mean, std, src = stats_mod.load_fold_normalization(cfg.data_dir, fold)
    print(f"[Normalization] fold {fold}: mean={mean:.6f} std={std:.6f} ({src})")
    return fold_dir, mean, std


def init_model(cfg: TrainFoldConfig):
    """(params, model_cfg): pretrained load + fresh 2-class head (the
    reference's ignore_mismatched_sizes + init_weights dance), with optional
    short-sequence positional-embedding adaptation; or, without a
    pretrained dir, a random init. f32 parameters on the CPU, drawn from
    `utils.prng.key(cfg.seed)`, the JAX trainer's `PRNGKey(cfg.seed)`: the
    fresh head (`reinit_head`) and the random init (`init_params`) are the
    JAX `init_model`'s bit for bit, and every fold starts from the
    identical tree."""
    rng = prng.key(cfg.seed)
    if cfg.pretrained_model_dir:
        if os.path.exists(os.path.join(cfg.pretrained_model_dir,
                                       "model_int8.safetensors")):
            raise ValueError(
                f"{cfg.pretrained_model_dir} is an int8 inference export "
                "(model_int8.safetensors) — quantization is lossy and not "
                "trainable; fine-tune from the f32 dir and re-export")
        params, model_cfg = convert.load_hf_model_dir(cfg.pretrained_model_dir)
        if model_cfg.num_labels != 2:
            model_cfg = dataclasses.replace(model_cfg, num_labels=2)
        params = ast_mod.reinit_head(rng, params, model_cfg, 2)
        if cfg.max_length and cfg.max_length != model_cfg.max_length:
            params, model_cfg = ast_mod.adapt_max_length(
                params, model_cfg, cfg.max_length)
            print(f"[MaxLength] adapted positional embeddings to "
                  f"{cfg.max_length} frames ({model_cfg.seq_length} tokens)")
    else:
        print("[WARN] no pretrained model dir; random init")
        model_cfg = ast_mod.ASTConfig(num_labels=2,
                                      max_length=cfg.max_length or 1024)
        params = ast_mod.init_params(rng, model_cfg)
    return params, model_cfg


def load_fold_splits(fold: int, cfg: TrainFoldConfig):
    """(train_x, train_y, test_x, test_y, val_x, val_y) with dry-run
    truncation and the reference's label sanity checks (:355-369)."""
    train_x, train_y = _load_split(cfg.data_dir, "train", fold)
    test_x, test_y = _load_split(cfg.data_dir, "test", fold)
    val_x, val_y = _load_split(cfg.data_dir, "val", fold)
    if train_x is None or test_x is None:
        raise FileNotFoundError(
            f"missing train/test npy files for fold {fold} in {cfg.data_dir}")
    if cfg.dry_run:
        train_x, train_y = train_x[:32], train_y[:32]
        test_x, test_y = test_x[:32], test_y[:32]
        if val_x is not None:
            val_x, val_y = val_x[:32], val_y[:32]
    for name, arr in [("train_y", train_y), ("test_y", test_y)] + (
            [("val_y", val_y)] if val_x is not None else []):
        uniq = sorted(set(arr.tolist()))
        if any(v not in (0, 1) for v in uniq):
            raise ValueError(f"Unexpected labels in {name} fold {fold}: {uniq}")
        if len(uniq) < 2:
            print(f"[WARN] Fold {fold} {name} single class: {uniq}")
    return train_x, train_y, test_x, test_y, val_x, val_y


def finalize_fold(fold: int, cfg: TrainFoldConfig, fold_dir: str, model_cfg,
                  mean: float, std: float, best_params, best_epoch: int,
                  best_f1: float, eval_feats, eval_y, has_val: bool,
                  test_feats, test_y, eval_step, device, tracker,
                  history, class_weights=None, mesh=None
                  ) -> dict[str, float]:
    """Best-model export + final metrics + CM artifacts (mirrors the
    reference's fold{k}/best export and per-split reports, :521-524,
    :542-644). The per-split metric dicts are shaped like
    `trainer.evaluate()` output — eval_-prefixed metrics plus eval_loss,
    speed metrics and the final epoch — so cv_metrics.npy keys match the
    executed reference. With `mesh` every rank evaluates (the eval step
    gathers over it) and its first rank writes."""
    print(f"[Best] fold {fold}: epoch {best_epoch} eval_f1={best_f1:.4f}")
    writer = _writer(mesh)
    best_dir = os.path.join(fold_dir, "best")
    labels_map = {i: name for i, name in enumerate(STAGE_LABELS[cfg.stage])}
    if writer:
        convert.save_hf_model_dir(best_params, model_cfg, best_dir,
                                  labels_map)
        save_feature_extractor_config(best_dir, mean, std,
                                      max_length=model_cfg.max_length)

    best_params = _to_device(best_params, device)
    loss_fn = _make_loss(cfg, class_weights)
    final_epoch = (float(history[-1]["epoch"]) if history
                   else float(max(best_epoch, 0)))
    metrics: dict[str, float] = {}
    prefix = "val" if has_val else "test_during_train"
    t0 = time.perf_counter()
    logits = _predict(eval_step, best_params, eval_feats, cfg.eval_batch_size,
                      device, mesh)
    eval_rt = time.perf_counter() - t0
    for k, v in metrics_mod.hf_eval_metrics(
            logits, eval_y, runtime=eval_rt, epoch=final_epoch,
            batch_size=cfg.eval_batch_size,
            loss=losses.hf_eval_loss(loss_fn, logits, eval_y,
                                     cfg.eval_batch_size)).items():
        metrics[f"fold{fold}_{prefix}_{k}"] = v
    if eval_feats is test_feats:
        # no val split: the eval split IS the test split — reuse the pass
        # above instead of running an identical full forward again
        test_logits = logits
        test_rt = eval_rt
    else:
        t0 = time.perf_counter()
        test_logits = _predict(eval_step, best_params, test_feats,
                               cfg.eval_batch_size, device, mesh)
        test_rt = time.perf_counter() - t0
    for k, v in metrics_mod.hf_eval_metrics(
            test_logits, test_y, runtime=test_rt, epoch=final_epoch,
            batch_size=cfg.eval_batch_size,
            loss=losses.hf_eval_loss(loss_fn, test_logits, test_y,
                                     cfg.eval_batch_size)).items():
        metrics[f"fold{fold}_test_{k}"] = v
        if cfg.stage == "stage2":
            # the stage-2 reference also duplicates test metrics under
            # generic names for sweep optimization
            # (train_ast_stage2_cross_validation.py:592-597)
            metrics[f"test_{k.replace('eval_', '')}"] = v

    if writer and not cfg.dry_run:
        splits = [("test", test_logits, test_y)]
        if has_val:
            splits.append(("val", logits, eval_y))
        for split_name, lg, yy in splits:
            cm, report = metrics_mod.confusion_and_report(
                yy, lg.argmax(1), STAGE_LABELS[cfg.stage])
            eval_dir = os.path.join(best_dir, f"evaluation_{split_name}")
            os.makedirs(eval_dir, exist_ok=True)
            np.save(os.path.join(eval_dir, "confusion_matrix.npy"), cm)
            with open(os.path.join(eval_dir, "classification_report.txt"),
                      "w") as f:
                f.write(report)
            if tracker is not None:
                _track_split_report(tracker, cfg.stage, fold, split_name, cm,
                                    yy, lg.argmax(1), eval_dir)

    if writer:
        with open(os.path.join(fold_dir, "history.json"), "w") as f:
            json.dump(history, f, indent=2)
    _barrier(mesh)
    return metrics


@dataclasses.dataclass
class FoldProgress:
    """Per-fold epoch-end bookkeeping state."""
    patience_left: int
    best_f1: float = -1.0
    best_params: Any = None
    best_epoch: int = -1
    stopped: bool = False
    history: list = dataclasses.field(default_factory=list)
    checkpoints: list = dataclasses.field(default_factory=list)


def epoch_bookkeeping(cfg: TrainFoldConfig, fold_dir: str, epoch: int,
                      steps_per_epoch: int, checkpoint_limit: int, m: dict,
                      has_val: bool, prog: FoldProgress, snapshot,
                      rng_state, label: str = "", mesh=None) -> None:
    """The epoch tail: best-F1/patience update (reference
    load_best_model_at_end + EarlyStoppingCallback semantics), best-weights
    persist for resume, rotating full checkpoint (save_total_limit), and the
    early-stop decision — sets prog.stopped. `snapshot()` -> (params_host,
    opt_state) for this fold; the caller appends to prog.history BEFORE
    calling. With `mesh` its first rank writes the files and the others
    wait at a barrier: every rank holds the same metrics, so all take the
    same branches."""
    writer = _writer(mesh)
    params_now, opt_now = snapshot()
    f1 = m["f1"]
    # HF EarlyStoppingCallback.check_metric_value resets the patience
    # counter on the FIRST eval unconditionally, afterwards only when the
    # metric is strictly greater AND the margin (computed as a difference,
    # not a shifted comparison — bit-faithful at threshold boundaries)
    # strictly exceeds the threshold. The no-threshold best update below
    # mirrors Trainer._determine_best_metric, which runs AFTER on_evaluate —
    # so each epoch's patience check compares against the previous epoch's
    # best.
    if prog.best_f1 < 0 or (
            f1 > prog.best_f1
            and (f1 - prog.best_f1) > cfg.early_stopping_threshold):
        prog.best_f1, prog.best_params, prog.best_epoch = f1, params_now, epoch
        prog.patience_left = cfg.early_stopping_patience
    else:
        if f1 > prog.best_f1:
            prog.best_f1 = f1
            prog.best_params = params_now
            prog.best_epoch = epoch
        prog.patience_left -= 1

    if writer and prog.best_epoch == epoch:  # best weights for resume
        convert.write_safetensors(
            _flat_params(prog.best_params),
            os.path.join(fold_dir, "best_params.safetensors"))

    ck = os.path.join(fold_dir, f"checkpoint-{epoch * steps_per_epoch}")
    if writer:
        save_checkpoint(ck, params_now, opt_now, {
            "epoch": epoch, "best_f1": prog.best_f1,
            "best_epoch": prog.best_epoch,
            "patience_left": prog.patience_left,
            "rng_state": rng_state,
            "history": prog.history,
        })
    prog.checkpoints.append(ck)
    while len(prog.checkpoints) > checkpoint_limit:
        old = prog.checkpoints.pop(0)
        if writer:
            shutil.rmtree(old, ignore_errors=True)
    _barrier(mesh)

    if has_val and cfg.enable_early_stopping and prog.patience_left <= 0:
        print(f"[EarlyStop]{label} no f1 improvement > "
              f"{cfg.early_stopping_threshold} for "
              f"{cfg.early_stopping_patience} epochs")
        prog.stopped = True


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms inside the block, the previous
    setting restored after it. Otherwise the patch convolution's weight
    gradient may be summed in an order that changes from run to run, two
    runs of one fold differ in the last bits, and `--resume` could not
    reproduce a straight run (XLA's are deterministic)."""
    previous = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = previous


@_deterministic_cudnn()
def train_fold(fold: int, cfg: TrainFoldConfig,
               tracker=None) -> dict[str, float]:
    """`tracker`: optional utils.tracking.Run; receives per-epoch metrics,
    confusion-matrix plots, and classification-report tables (the
    reference's W&B channels, src/train_ast_stage1_cross_validation.py:
    564-637)."""
    print(f"\n===== {cfg.stage} Fold {fold} =====")
    device = resolve_device(cfg.device)
    mesh = None
    if (cfg.num_devices or 1) > 1 or (cfg.num_slices or 1) > 1:
        # a batch size that never divides would run every batch whole on
        # every rank while the banner claims data parallelism — reject it
        # before any run-dir side effect (batch_size is CLI-exposed)
        n_dev = cfg.num_devices or 1
        if n_dev > 1 and cfg.batch_size % n_dev != 0:
            raise ValueError(
                f"batch_size {cfg.batch_size} is not divisible by the "
                f"{n_dev}-device mesh; every batch would fall back to a "
                f"single device — choose a batch_size divisible by "
                f"num_devices")
        mesh = pmesh.make_mesh(cfg.num_devices, cfg.num_slices,
                               device=cfg.device)
    if mesh is not None:
        n_dev = pmesh.mesh_size(mesh)
        topo = " x ".join(f"{mesh.mesh.shape[i]} ({a})"
                          for i, a in enumerate(mesh.mesh_dim_names))
        print(f"[Mesh] data-parallel training over {n_dev} devices: {topo}")
        # eval_batch_size is not CLI-exposed and only affects eval-side
        # speed (per-sample logits do not depend on the chunk): round it
        # up to the next mesh multiple instead of erroring
        if cfg.eval_batch_size % n_dev != 0:
            bumped = -(-cfg.eval_batch_size // n_dev) * n_dev
            print(f"[Mesh] eval_batch_size {cfg.eval_batch_size} -> "
                  f"{bumped} (rounded up to a {n_dev}-device multiple so "
                  f"eval chunks shard)")
            cfg = dataclasses.replace(cfg, eval_batch_size=bumped)
    fold_dir, mean, std = prepare_fold_dir(fold, cfg, mesh)

    params, model_cfg = init_model(cfg)
    train_x, train_y, test_x, test_y, val_x, val_y = load_fold_splits(fold,
                                                                      cfg)

    aug_rng = np.random.default_rng(cfg.seed) if cfg.augment else None
    mf = model_cfg.max_length
    if cfg.streaming:
        train_feats = FeatureStream(train_x, mean, std, aug_rng,
                                    max_frames=mf, device=device)
    else:
        train_feats = featurize_paths(train_x, mean, std, aug_rng,
                                      max_frames=mf, device=device)
    test_feats = featurize_paths(test_x, mean, std, max_frames=mf,
                                 device=device)
    val_feats = (featurize_paths(val_x, mean, std, max_frames=mf,
                                 device=device)
                 if val_x is not None else None)
    has_val = val_feats is not None

    class_weights = None
    if cfg.stage == "stage2" and cfg.use_class_weights:
        class_weights = losses.inverse_frequency_weights(train_y)
        print(f"[ClassWeights] {class_weights}")

    n = len(train_feats)
    num_epochs = 1 if cfg.dry_run else cfg.num_epochs
    steps_per_epoch = -(-n // cfg.batch_size)
    # the LR schedule counts OPTIMIZER steps: with gradient accumulation
    # there is one update per `accum` micro-batches, so warmup_ratio and
    # the decay keep their meaning at any effective batch size
    accum = max(1, cfg.grad_accum)
    opt_steps_per_epoch = -(-steps_per_epoch // accum)
    total_steps = num_epochs * opt_steps_per_epoch
    tx = optim.make_optimizer(cfg.learning_rate, total_steps,
                              cfg.warmup_ratio, cfg.weight_decay,
                              beta2=cfg.adam_beta2)
    params = _to_device(params, device)
    opt_state = tx.init(params)
    loss_fn = _make_loss(cfg, class_weights)
    if accum > 1:
        print(f"[GradAccum] {accum} micro-batches of {cfg.batch_size} per "
              f"update (effective batch {accum * cfg.batch_size})")
        grad_step, apply_step = steps.make_accum_steps(
            tx, model_cfg, loss_fn, dtype=cfg.dtype, mesh=mesh)
        train_step = None
    else:
        train_step = steps.make_train_step(tx, model_cfg, loss_fn,
                                           dtype=cfg.dtype, mesh=mesh)
    eval_step = steps.make_eval_step(model_cfg, dtype=cfg.dtype, mesh=mesh,
                                     device=device)

    checkpoint_limit = 1 if cfg.dry_run else max(2, (cfg.num_epochs + 1) // 2)
    epoch_rng = np.random.default_rng(cfg.seed)
    eval_feats = val_feats if has_val else test_feats
    eval_y = val_y if has_val else test_y

    prog = FoldProgress(patience_left=cfg.early_stopping_patience)
    start_epoch = 1

    if cfg.resume:
        ck = latest_checkpoint(fold_dir)
        if ck:
            params, opt_state, st = load_checkpoint(ck, params, opt_state)
            start_epoch = st["epoch"] + 1
            prog.best_f1 = st["best_f1"]
            prog.best_epoch = st["best_epoch"]
            prog.patience_left = st["patience_left"]
            epoch_rng.bit_generator.state = st["rng_state"]
            prog.history = st.get("history", [])
            bp = os.path.join(fold_dir, "best_params.safetensors")
            if prog.best_epoch > 0 and os.path.exists(bp):
                prog.best_params = _params_from_flat(
                    convert.read_safetensors(bp), _to_host(params))
            # seed rotation with the PRIOR run's checkpoints (oldest first)
            # so save_total_limit keeps bounding disk across resume cycles
            prog.checkpoints = [
                p for _, p in sorted(
                    (int(n.split("-", 1)[1]), os.path.join(fold_dir, n))
                    for n in os.listdir(fold_dir)
                    if n.startswith("checkpoint-")
                    and n.split("-", 1)[1].isdigit())]
            print(f"[Resume] from {ck}: next epoch {start_epoch}, "
                  f"best_f1={prog.best_f1:.4f} @ epoch {prog.best_epoch}")
        else:
            print("[Resume] no checkpoint found; training from scratch")

    if mesh is not None:
        pmesh.replicate(params, mesh)
        pmesh.replicate(opt_state, mesh)

    is_stream = isinstance(train_feats, FeatureStream)
    grad_buf = (optim.tree_map(torch.zeros_like, params) if accum > 1
                else None)
    micro_in_group = 0
    group_loss = 0.0
    global_step = (start_epoch - 1) * opt_steps_per_epoch
    labels_all = torch.from_numpy(train_y.astype(np.int64))
    for epoch in range(start_epoch, num_epochs + 1):
        order = epoch_rng.permutation(n)
        epoch_loss = 0.0
        if is_stream:
            train_feats.prefetch(order[: cfg.batch_size])
        for s in range(0, n, cfg.batch_size):
            idx = order[s: s + cfg.batch_size]
            if is_stream:
                batch_feats = train_feats.gather(idx)
                nxt = order[s + cfg.batch_size: s + 2 * cfg.batch_size]
                if len(nxt):  # overlap next batch's decode with this step
                    train_feats.prefetch(nxt)
            else:
                batch_feats = train_feats[idx]
            # with a mesh the global batch stays on the host: the step
            # moves this rank's rows
            feats = torch.from_numpy(batch_feats)
            if mesh is None:
                feats = feats.to(device)
            labels = labels_all[idx].to(device)
            step_loss = None
            if accum > 1:
                grad_buf, loss_val, _ = grad_step(params, grad_buf, feats,
                                                  labels)
                micro_in_group += 1
                # the losses stay on the device until the apply step: a
                # host read per micro-batch would wait for each in turn
                group_loss = group_loss + loss_val
                epoch_loss = epoch_loss + loss_val * len(idx)
                # update on a full group or on the epoch's last micro-batch
                # (a short trailing group averages over its actual count)
                if micro_in_group == accum or s + cfg.batch_size >= n:
                    params, opt_state, grad_buf = apply_step(
                        params, opt_state, grad_buf, float(micro_in_group))
                    step_loss = float(group_loss) / micro_in_group
                    micro_in_group = 0
                    group_loss = 0.0
            else:
                params, opt_state, loss_val, _ = train_step(
                    params, opt_state, feats, labels)
                step_loss = float(loss_val)
                epoch_loss += step_loss * len(idx)
            if step_loss is not None:
                # global_step counts OPTIMIZER updates (the HF Trainer
                # global_step at any accumulation factor), so the per-step
                # loss channel, checkpoint-N and the LR schedule share ONE
                # step axis
                global_step += 1
                if (tracker is not None and cfg.logging_steps
                        and global_step % cfg.logging_steps == 0):
                    tracker.log({"fold": fold, "train_step": global_step,
                                 "train_step_loss": step_loss})
        epoch_loss = float(epoch_loss) / n

        logits = _predict(eval_step, params, eval_feats, cfg.eval_batch_size,
                          device, mesh)
        m = metrics_mod.compute_metrics_from_logits(logits, eval_y)
        m["loss"] = epoch_loss
        prog.history.append({"epoch": epoch, **m})
        print(f"[Epoch {epoch}/{num_epochs}] loss={epoch_loss:.4f} "
              f"eval_f1={m['f1']:.4f} acc={m['accuracy']:.4f}")
        if tracker is not None:
            # no explicit step: in the shared-run mode folds restart epochs
            # at 1, and wandb rejects non-monotonic steps
            tracker.log({"fold": fold, "epoch": epoch,
                         **{f"eval_{k}" if k != "loss" else "train_loss": v
                            for k, v in m.items()}})

        # checkpoint-N counts optimizer steps (= micro-steps at accum 1,
        # the HF Trainer convention at any accumulation factor)
        epoch_bookkeeping(cfg, fold_dir, epoch, opt_steps_per_epoch,
                          checkpoint_limit, m, has_val, prog,
                          snapshot=lambda: (_to_host(params), opt_state),
                          rng_state=epoch_rng.bit_generator.state,
                          mesh=mesh)
        if prog.stopped:
            break

        if cfg.on_epoch_end is not None and cfg.on_epoch_end(epoch, m):
            print(f"[Sweep] externally terminated after epoch {epoch}")
            break

    if is_stream:
        train_feats.close()
    if prog.best_params is None:
        prog.best_params = _to_host(params)
    return finalize_fold(fold, cfg, fold_dir, model_cfg, mean, std,
                         prog.best_params, prog.best_epoch, prog.best_f1,
                         eval_feats, eval_y, has_val, test_feats, test_y,
                         eval_step, device, tracker, prog.history,
                         class_weights=class_weights, mesh=mesh)


def _track_split_report(tracker, stage: str, fold: int, split_name: str,
                        cm, y_true, y_pred, eval_dir: str) -> None:
    """CM plot + per-class classification-report table into the tracker
    (the reference's W&B CM/table channels,
    src/train_ast_stage1_cross_validation.py:564-637). Best-effort, like
    the reference's wide try/except around W&B plotting."""
    labels = STAGE_LABELS[stage]
    try:
        from ..analysis import cm_plots

        png = os.path.join(eval_dir, "confusion_matrix.png")
        cm_plots.plot_confusion_matrix_overlay(
            np.asarray(cm), labels, f"{stage} fold {fold} ({split_name})", png)
        tracker.log_image(f"fold{fold}_{split_name}_confusion_matrix", png)
    except Exception as exc:
        print(f"[tracking][WARN] CM plot failed: {exc}")
    try:
        tracker.log_table(
            f"fold{fold}_{split_name}_classification_report",
            ["class", "precision", "recall", "f1", "support"],
            metrics_mod.report_rows(y_true, y_pred, labels))
    except Exception as exc:
        print(f"[tracking][WARN] report table failed: {exc}")


# ---------------------------------------------------------------------------
# Checkpoint save/restore (params + optimizer state + loop state)
# ---------------------------------------------------------------------------


def _flat_params(params) -> dict[str, np.ndarray]:
    """The port's parameters (or a tree shaped like them, such as Adam's
    moments) under the JAX package's dotted names and layout, f32."""
    flat = convert._flatten_tree(convert.params_to_numpy(params))
    return {k: np.asarray(v, np.float32) for k, v in flat.items()}


def _params_from_flat(flat: dict, template):
    """Inverse of `_flat_params`: tensors of the template's structure, key
    order, dtypes and devices, from the dotted JAX-layout arrays in `flat`.
    The order matters: `optim.global_norm` sums the leaves in it, so a
    resumed run whose trees were in another order would clip its gradients
    by a norm an ulp apart from the straight run's."""
    names = sorted(_flat_params(template))
    if sorted(flat) != names:
        raise ValueError(f"parameter names differ from the model's: "
                         f"{sorted(set(flat) ^ set(names))[:5]}")
    tree = convert.params_from_jax(convert._unflatten_tree(flat))

    def like(old, new):
        if new.shape != old.shape:
            raise ValueError(f"a parameter of shape {tuple(new.shape)} where "
                             f"the model has {tuple(old.shape)}")
        return new.to(dtype=old.dtype, device=old.device)

    return optim.tree_map(like, template, tree)


def _adam_leaves(opt_state) -> list[np.ndarray]:
    """The port's AdamW state as the array leaves of the JAX optimizer
    state in its order: chain(clip_by_global_norm, adamw(schedule)) flattens
    to [scale_by_adam count, mu..., nu..., the schedule's count], mu and nu
    in the pytree's sorted-key order, in the JAX layout."""
    count = np.asarray(opt_state["count"], np.int32)
    moments = [_flat_params(opt_state[k]) for k in ("mu", "nu")]
    return [count, *(m[name] for m in moments for name in sorted(m)), count]


def sequential_opt_layout(opt_state) -> dict:
    """A parallel trainer's per-fold or per-trial optimizer state
    (`optim.adamw_init`'s {"count", "mu", "nu"}, one member's slice) in
    the sequential AdamW's layout, which `save_checkpoint` writes.

    The parallel trainers schedule the learning rate outside the optimizer,
    so their state has no schedule count; the sequential checkpoint ends in
    one (the JAX chain's ScaleByScheduleState), which `_adam_leaves` writes
    as the Adam count, the number of updates taken. So the layouts differ
    only in the count's type, and a parallel checkpoint resumes in the
    sequential trainer of either package."""
    return {"count": int(opt_state["count"]), "mu": opt_state["mu"],
            "nu": opt_state["nu"]}


def save_checkpoint(ck_dir: str, params, opt_state, state: dict) -> None:
    """Full training checkpoint in the JAX package's layout:
    `params.safetensors` (the parameters under their dotted names),
    `opt_state.safetensors` (the optimizer state's array leaves as
    leaf_NNNN, in the JAX optimizer's order, `_adam_leaves`) and
    `train_state.json` (the loop state).

    Written into `<ck_dir>.tmp` and atomically renamed into place: a crash
    mid-save must not leave a partial checkpoint under the final name,
    because latest_checkpoint() would pick it over the older INTACT one and
    --resume would fail instead of recovering. The ".tmp" suffix makes the
    staging dir invisible to both checkpoint scanners (their
    int(name.split("-",1)[1]) / .isdigit() parses reject it)."""
    tmp_dir = ck_dir + ".tmp"
    if os.path.exists(tmp_dir):  # stale staging dir from a crashed save
        shutil.rmtree(tmp_dir)
    os.makedirs(tmp_dir)
    convert.write_safetensors(_flat_params(params),
                              os.path.join(tmp_dir, "params.safetensors"))
    convert.write_safetensors(
        {f"leaf_{i:04d}": leaf
         for i, leaf in enumerate(_adam_leaves(opt_state))},
        os.path.join(tmp_dir, "opt_state.safetensors"))
    with open(os.path.join(tmp_dir, "train_state.json"), "w") as f:
        json.dump(state, f, indent=2, default=float)
    if os.path.exists(ck_dir):  # same-name leftover from a pre-atomicity run
        shutil.rmtree(ck_dir)
    os.rename(tmp_dir, ck_dir)


def load_checkpoint(ck_dir: str, params_template, opt_state_template):
    """Inverse of save_checkpoint; the templates give structure, dtypes and
    devices. Returns (params, opt_state, state)."""
    params = _params_from_flat(
        convert.read_safetensors(os.path.join(ck_dir, "params.safetensors")),
        params_template)

    opt_flat = convert.read_safetensors(
        os.path.join(ck_dir, "opt_state.safetensors"))
    names = sorted(_flat_params(opt_state_template["mu"]))
    n = len(names)
    if len(opt_flat) != 2 + 2 * n:
        raise ValueError(
            f"optimizer-state layout mismatch in {ck_dir}: checkpoint has "
            f"{len(opt_flat)} array leaves, the AdamW state expects "
            f"{2 + 2 * n} (its count, {n} first and {n} second moments, "
            f"the schedule's count)")
    leaves = [opt_flat[f"leaf_{i:04d}"] for i in range(2 + 2 * n)]
    # the safetensors writer stores a 0-d count as (1,)
    count = int(np.asarray(leaves[0]).reshape(()))
    mu, nu = ({name: leaf for name, leaf in zip(names, part)}
              for part in (leaves[1: 1 + n], leaves[1 + n: 1 + 2 * n]))
    opt_state = {"count": count,
                 "mu": _params_from_flat(mu, opt_state_template["mu"]),
                 "nu": _params_from_flat(nu, opt_state_template["nu"])}
    state_path = os.path.join(ck_dir, "train_state.json")
    state = fsio.load_json_object(state_path, "train state")
    # checkpoint dirs are written atomically (tmp dir + rename), so a
    # malformed state here means external tampering or a hand-edited file —
    # name exactly what is wrong instead of KeyError-ing deep in the
    # resume loop (resume reads every one of these fields).
    required = {"epoch": int, "best_f1": (int, float), "best_epoch": int,
                "patience_left": int, "rng_state": dict}
    for key, typ in required.items():
        if key not in state:
            raise ValueError(f"train state {state_path} is missing "
                             f"required key {key!r}")
        if not isinstance(state[key], typ) or isinstance(state[key], bool):
            raise ValueError(
                f"train state {state_path} key {key!r} must be "
                f"{getattr(typ, '__name__', 'numeric')}, got "
                f"{type(state[key]).__name__}")
    return params, opt_state, state


def latest_checkpoint(fold_dir: str) -> str | None:
    cks = []
    if not os.path.isdir(fold_dir):
        return None
    for name in os.listdir(fold_dir):
        if name.startswith("checkpoint-"):
            try:
                cks.append((int(name.split("-", 1)[1]),
                            os.path.join(fold_dir, name)))
            except ValueError:
                continue
    if not cks:
        return None
    return max(cks)[1]


def run_cross_validation(folds, cfg: TrainFoldConfig,
                         run_config_extra: dict | None = None,
                         tracking_opts: dict | None = None) -> dict:
    """Train the given folds and write cv_metrics.npy/.txt + run-config
    snapshot (reference :772-784, :887-910).

    tracking_opts maps the reference's W&B surface onto utils/tracking.Run:
    {"enabled": bool, "project": str, "group": str, "offline": bool,
    "per_fold": bool}. per_fold replicates --wandb-per-fold (reference
    :824-864): one run per fold grouped under the run id, plus a final
    cv_summary run carrying the aggregate metrics (:922-941).

    In a process group (several devices) every rank runs this and the
    first one writes the run's files and keeps its trackers."""
    resolve_device(cfg.device)  # before any file is written
    writer = pmesh.is_main()
    os.makedirs(cfg.output_root, exist_ok=True)
    run_started = datetime.now()
    topts = tracking_opts or {}
    folds = list(folds)
    run_config = {
        "run_id": run_started.strftime("%Y%m%d_%H%M%S"),
        "timestamp": run_started.isoformat(),
        # schema mirrors the reference's build_run_config snapshot
        # (train_ast_stage1_cross_validation.py:108-158)
        "script": f"train_ast_{cfg.stage}_cross_validation",
        "stage": cfg.stage,
        "pretrained_model": (cfg.pretrained_model_dir
                             or "MIT/ast-finetuned-audioset-10-10-0.4593"),
        "seed": cfg.seed,
        "num_epochs": 1 if cfg.dry_run else cfg.num_epochs,
        "per_device_train_batch_size": cfg.batch_size,
        "learning_rate": cfg.learning_rate,
        "optimizer": {
            "name": "adamw",
            "weight_decay": cfg.weight_decay,
            "warmup_ratio": cfg.warmup_ratio,
            "adam_beta2": cfg.adam_beta2,
        },
        "loss": {
            "focal_gamma": cfg.focal_gamma,
            "label_smoothing": cfg.label_smoothing,
        },
        "dry_run": cfg.dry_run,
        "target_folds": folds,
        "fold_requested": folds[0] if len(folds) == 1 else None,
        "early_stopping": {
            "enabled": cfg.enable_early_stopping,
            "patience": cfg.early_stopping_patience,
        },
        # the reference SNAPSHOT divides by 4 while its train_fold divides
        # by 2 (an upstream inconsistency, :118 vs :475) — mirror both
        "checkpoint_limit": 1 if cfg.dry_run else max(
            2, (cfg.num_epochs + 1) // 4),
        "paths": {"data_dir": cfg.data_dir, "output_root": cfg.output_root,
                  "log_dir": os.path.join(cfg.output_root, "tracking")},
        "wandb": {
            "enabled": topts.get("enabled", True),
            "project": topts.get("project") or f"zenker-ast-{cfg.stage}",
            "entity": topts.get("entity"),
            "group": topts.get("group"),
            "per_fold": topts.get("per_fold", False),
            "offline": topts.get("offline", False),
        },
        **(run_config_extra or {}),
    }
    config_path = os.path.join(
        cfg.output_root, f"run_config_{run_config['run_id']}.json")
    if writer:
        with open(config_path, "w") as f:
            json.dump(run_config, f, indent=2)

    from ..utils import tracking

    per_fold_runs = topts.get("per_fold", False)
    group = topts.get("group") or (run_config["run_id"] if per_fold_runs
                                   else None)

    def make_run(name):
        if not writer:
            return None
        return tracking.Run(
            project=topts.get("project") or f"zenker-ast-{cfg.stage}",
            name=name, config=run_config, group=group,
            dir=os.path.join(cfg.output_root, "tracking"),
            use_wandb=topts.get("enabled", True),
            offline=topts.get("offline", False),
            entity=topts.get("entity"))

    run = None if per_fold_runs else make_run(run_config["run_id"])
    if run is not None:
        run.log_artifact(config_path)

    def fold_tracker(fold):
        fold_run = (make_run(f"{run_config['run_id']}_fold{fold}")
                    if per_fold_runs else run)
        if per_fold_runs and fold_run is not None:
            fold_run.log_artifact(config_path)
        return fold_run

    def fold_done(fold, fold_run, m):
        if not writer:
            return
        shutil.copy2(config_path,
                     os.path.join(cfg.output_root, f"fold{fold}",
                                  "run_config.json"))
        fold_run.log(m)
        if per_fold_runs:
            fold_run.summary(**m)
            fold_run.finish()

    all_metrics = []
    if cfg.fold_parallel:
        from . import fold_parallel

        fold_runs = {fold: fold_tracker(fold) for fold in folds}
        all_metrics = fold_parallel.train_folds_parallel(
            folds, cfg, trackers=fold_runs)
        for fold, m in zip(folds, all_metrics):
            fold_done(fold, fold_runs[fold], m)
    else:
        for fold in folds:
            fold_run = fold_tracker(fold)
            m = train_fold(fold, cfg, tracker=fold_run)
            all_metrics.append(m)
            fold_done(fold, fold_run, m)

    aggregate: dict[str, float] = {}
    names = {k.split("_test_", 1)[1] for d in all_metrics
             for k in d if "_test_" in k}
    for name in names:
        vals = [d[k] for d in all_metrics for k in d
                if k.endswith(f"_test_{name}")]
        if vals:
            aggregate[f"{name}_mean"] = float(np.mean(vals))
            aggregate[f"{name}_std"] = float(np.std(vals))

    if not writer:
        return {"per_fold": all_metrics, "aggregate": aggregate}
    np.save(os.path.join(cfg.output_root, "cv_metrics.npy"),
            {"per_fold": all_metrics, "aggregate": aggregate})
    with open(os.path.join(cfg.output_root, "cv_metrics.txt"), "w") as f:
        f.write("Per-fold metrics:\n")
        for m in all_metrics:
            f.write(str(m) + "\n")
        f.write("\nAggregate metrics:\n")
        f.write(str(aggregate) + "\n")
    if per_fold_runs:  # dedicated summary run (reference :922-941)
        run = make_run(f"{run_config['run_id']}_cv_summary")
        run.log(aggregate)
    run.summary(**aggregate)
    run.finish()
    for k, v in sorted(aggregate.items()):
        print(f"  {k}: {v:.4f}")
    return {"per_fold": all_metrics, "aggregate": aggregate}
