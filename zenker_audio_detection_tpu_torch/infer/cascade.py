"""Two-stage AST cascade inference engine, in PyTorch.

Port of the JAX package's `infer/cascade.py`, the reference's serving path
(src/test_long_audio_windows_2stage.py and the cached variant
src/test_long_audio_windows_2stage_cache.py):

  file-level log-mel frames computed ONCE on the device (overlapping
  1 s / 0.5 s windows share 48 of 98 frames), window features gathered from
  them, Stage 1 on every window, the reference's gate on the host, and
  Stage 2 on the gated windows ("gated") or on every window ("all"), in
  fixed-size chunks whose results are fetched only after all are queued.

Under a profiler each recording is one `cascade.recording` span
(`infer_file`) holding flat, non-overlapping siblings in this order:
`cascade.frontend` (the padding, the upload, the file-level log-mel or the
samples buffer, the cache lookup), `cascade.stage1` (its starts to the
device and its chunks queued), `cascade.fetch` (its probabilities to the
host, the mesh's gather included), `cascade.gate` (gated mode: the gate
and the stage-2 selection), `cascade.stage2` and `cascade.fetch` (when a
window is left to run), `cascade.summary` (`gate_and_summarize`).
`run_patient` adds one `cascade.summary` for the patient's JSON.

A stage is an AST (`models.ast`) or BEATs (`models.beats`): the engine
picks each stage's model module once, when it is built
(`models.module_for`), and computes one front end for both, so the two
stages must share it (`ops.fbank.FrontEnd`: the window type and the audio
scale). int8 and the raw-frame cache take AST stages only.

Numerical contract: per-window probabilities equal the JAX engine's at the
stated tolerances; the gating/summary math on top is replicated exactly
(including the reference quirk that summary swallow counts use raw argmax
while Stage-2 selection uses thresholded predictions —
src/test_long_audio_windows_2stage.py:312-317 vs :150-153).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Any, Sequence

import numpy as np
import torch
import torch.nn.functional as nnf

from .. import models
from ..models import ast as ast_mod
from ..models import beats as beats_mod
from ..ops import fbank as F
from ..parallel import mesh as pmesh
from ..utils.profiling import span

SAMPLING_RATE = 16000


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA. Raises when CUDA is asked for and missing: the
    engine does not carry on on the CPU unless the caller names it."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run on the CPU")
    return device


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One stage's model + feature normalization (the `fold{k}/best/`
    equivalent: weights travel with their feature-extractor stats)."""

    params: Any
    config: ast_mod.ASTConfig | beats_mod.BEATsConfig
    mean: float
    std: float
    label_order: tuple[str, str]


@dataclasses.dataclass(frozen=True)
class CascadeConfig:
    window_sec: float = 1.0
    hop_sec: float = 0.5
    batch_size: int = 128
    stage1_threshold: float = 0.5
    stage2_threshold: float = 0.5
    stage1_forward_min_prob: float | None = None
    stage2_argmax: bool = False
    dtype: torch.dtype = torch.bfloat16
    # raw-frame cache (infer/cache.py); None disables caching
    cache_dir: str | None = None
    refresh_cache: bool = False
    # "gated": Stage 2 runs only on windows that pass the Stage-1 gate (the
    # reference's own semantics; one host sync for the gate).
    # "all": Stage 2 on every window, no host sync between the stages.
    stage2_mode: str = "gated"
    # "kernel": attention through the hand-written CUDA kernel
    # (ops/attention.py:mha_packed); "torch": its plain PyTorch version
    attention_impl: str = "kernel"
    # int8 inference: the encoder's dense layers run int8 x int8 -> int32
    # with per-channel weight and per-token activation quantization
    # (models/ast.py:quantize_params). Probabilities shift O(1e-2):
    # recalibrate the gate thresholds on validation data when enabled.
    # AST stages only.
    int8: bool = False


def window_starts(num_samples: int, window_sec: float, hop_sec: float,
                  sr: int = SAMPLING_RATE) -> np.ndarray:
    """Start sample of every window, matching `window_audio`
    (src/test_long_audio_windows_2stage.py:62-75): full windows only, except
    a single zero-padded window when the file is shorter than the window."""
    win = int(window_sec * sr)
    hop = int(hop_sec * sr)
    return np.arange(0, max(1, num_samples - win + 1), hop, dtype=np.int64)


def _next_pow2(n: int, floor: int = 1024) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


class TwoStageEngine:
    """Fold-resident two-stage engine: load models once, serve every patient
    (vs the reference's model-reload-per-patient subprocess fan-out,
    src/run_batch_simple_2stage.py:282-284)."""

    def __init__(self, stage1: StageSpec, stage2: StageSpec,
                 config: CascadeConfig = CascadeConfig(), device=None,
                 mesh=None):
        """`device`: where the models and the work live; None means CUDA.
        `mesh`: optional `DeviceMesh` (parallel/mesh.py) over the ranks of
        a process group: the models are replicated, each chunk's windows
        sharded across its ranks and the probabilities gathered back in
        window order (every rank returns them). Single-device when None."""
        if config.stage2_mode not in ("gated", "all"):
            raise ValueError(
                f"stage2_mode must be 'gated' or 'all', got "
                f"{config.stage2_mode!r} (anything else would silently run "
                "gated mode)")
        if config.attention_impl not in ast_mod.ATTENTION_IMPLS:
            raise ValueError(f"attention_impl must be one of "
                             f"{ast_mod.ATTENTION_IMPLS}, got "
                             f"{config.attention_impl!r}")
        # each stage's model module, picked once
        self._models = {k: models.module_for(s.config)
                        for k, s in ((1, stage1), (2, stage2))}
        fronts = {m.FRONT_END for m in self._models.values()}
        if len(fronts) > 1:
            raise ValueError(
                "the two stages need one front end (window type and audio "
                f"scale), got {self._models[1].FRONT_END} for stage 1 and "
                f"{self._models[2].FRONT_END} for stage 2: an AST stage and "
                "a BEATs stage cannot share an engine")
        self.front_end = fronts.pop()
        if config.int8 and not all(hasattr(m, "quantize_params")
                                   for m in self._models.values()):
            raise ValueError("int8 takes AST stages only "
                             "(models/ast.py:quantize_params), not BEATs")
        if config.cache_dir is not None and self.front_end != F.FrontEnd():
            raise ValueError("the raw-frame cache keys the AST front end "
                             "only; run BEATs stages without cache_dir")
        self.device = resolve_device(device)
        if config.int8:
            stage1 = dataclasses.replace(stage1, params=self._models[1]
                                         .quantize_params(stage1.params))
            stage2 = dataclasses.replace(stage2, params=self._models[2]
                                         .quantize_params(stage2.params))
        self.stage1 = stage1
        self.stage2 = stage2
        self.config = config
        self.mesh = mesh
        if mesh is not None:
            n_dev = pmesh.mesh_size(mesh)
            if config.batch_size % n_dev:
                raise ValueError(
                    f"batch_size {config.batch_size} must divide across "
                    f"{n_dev} devices")
        win = int(config.window_sec * SAMPLING_RATE)
        hop = int(config.hop_sec * SAMPLING_RATE)
        self._win = win
        self._hop = hop
        self._frames_per_window = F.num_frames(win)
        if self._frames_per_window <= 0:
            raise ValueError("window shorter than one fbank frame")
        for spec in (stage1, stage2):
            if self._frames_per_window > spec.config.max_length:
                raise ValueError(
                    f"{config.window_sec}s windows produce "
                    f"{self._frames_per_window} frames > the model's "
                    f"max_length {spec.config.max_length}")
        # Frame reuse is exact only when window starts land on the 10 ms
        # frame grid; otherwise each window is featurized from its samples.
        self._frame_reuse = (hop % F.HOP_LENGTH == 0)
        self._params1 = self._models[1].cast_params(stage1.params,
                                                    config.dtype, self.device)
        self._params2 = self._models[2].cast_params(stage2.params,
                                                    config.dtype, self.device)
        if mesh is not None:
            pmesh.replicate(self._params1, mesh)
            pmesh.replicate(self._params2, mesh)
        # (mean, 2 * std) of each stage as f32 device scalars, made once: a
        # host-to-device copy per chunk would wait for the queued chunks
        self._norm = {
            k: (torch.tensor(s.mean, dtype=torch.float32, device=self.device),
                torch.tensor(2.0 * s.std, dtype=torch.float32,
                             device=self.device))
            for k, s in ((1, stage1), (2, stage2))}

    # ---------------- device work ----------------

    def _stage_probs(self, stage: int, kind: str, device_buf: torch.Tensor,
                     starts: torch.Tensor) -> torch.Tensor:
        """Softmax probabilities (C, 2) of one chunk of windows.

        kind "frames": gather fpw-frame blocks from file-level log-mel;
        kind "samples": gather raw windows and fbank them (non-grid hops).
        The starts are in range by construction (the buffers are padded to
        cover the last window), so the gathers need no check here."""
        fpw = self._frames_per_window
        if kind == "frames":
            offs = torch.arange(fpw, device=self.device)
            raw = device_buf[starts[:, None] + offs[None, :]]  # (C, fpw, 128)
        else:
            offs = torch.arange(self._win, device=self.device)
            raw = F.logmel_frames(device_buf[starts[:, None] + offs[None, :]],
                                  fpw, front_end=self.front_end)
        return self._classify(stage, raw)

    def _classify(self, stage: int, raw: torch.Tensor) -> torch.Tensor:
        """Softmax probabilities (C, 2) of one stage on (C, frames, 128)
        raw log-mel windows: pad-then-normalize (HF order: pad rows become
        (0 - mean) / (2 std)), the stage's model, the softmax. The offline
        chunks and the streaming ring (infer/streaming.py) share it."""
        spec = self.stage1 if stage == 1 else self.stage2
        params = self._params1 if stage == 1 else self._params2
        mean, denom = self._norm[stage]
        raw = nnf.pad(raw, (0, 0, 0, spec.config.max_length - raw.shape[-2]))
        feats = (raw - mean) / denom
        logits = self._models[stage].forward(
            params, feats, spec.config, dtype=self.config.dtype,
            attention_impl=self.config.attention_impl)
        return torch.softmax(logits, dim=-1)

    def _gate_indices(self, s1_probs: np.ndarray) -> np.ndarray:
        """Window indices forwarded to Stage 2 — the reference's gate
        (argmax==Swallow AND p_swallow >= threshold, then the optional
        --stage1-forward-min-prob second gate,
        src/test_long_audio_windows_2stage_cache.py:463-478)."""
        cfg = self.config
        p_swallow = s1_probs[:, 1]
        preds = s1_probs.argmax(axis=1)
        preds = np.where((preds == 1) & (p_swallow >= cfg.stage1_threshold), 1, 0)
        idx = np.where(preds == 1)[0]
        if cfg.stage1_forward_min_prob is not None and len(idx):
            idx = idx[p_swallow[idx] >= cfg.stage1_forward_min_prob]
        return idx

    # ---------------- host orchestration ----------------

    @torch.inference_mode()
    def window_probs(self, audio: np.ndarray,
                     path: str | None = None) -> tuple[np.ndarray, np.ndarray]:
        """All-window probabilities for one recording.

        Returns (stage1_probs (W, 2), stage2_probs (W, 2)) as float64. In
        "gated" mode stage2 rows are only evaluated for windows passing the
        Stage-1 gate (other rows are zero — exactly the rows the reference
        never computes); in "all" mode every row is evaluated. `path`
        enables the raw-frame cache when config.cache_dir is set.

        `audio` may be float32 or int16 PCM; int16 is transferred as-is
        (half the host->device traffic) and scaled to float on the device.
        """
        with span("cascade.frontend"):
            kind, device_buf, stage_starts = self._frontend(audio, path)
        W = len(stage_starts)

        p1 = self._run_stage(1, kind, device_buf, stage_starts)
        if self.config.stage2_mode == "all":
            p2 = self._run_stage(2, kind, device_buf, stage_starts)
        else:
            with span("cascade.gate"):
                p2 = np.zeros((W, 2), np.float64)
                gated = self._gate_indices(p1)
                gated_starts = stage_starts[gated]
            if len(gated):
                p2[gated] = self._run_stage(2, kind, device_buf,
                                            gated_starts)
        return p1, p2

    def _frontend(self, audio, path):
        """(kind, device buffer, each window's start in it) of one
        recording: file-level log-mel frames ("frames", via the cache when
        enabled) when the hop lies on the frame grid, else the zero-padded
        samples ("samples")."""
        audio = np.asarray(audio)
        if audio.dtype != np.int16:
            audio = audio.astype(np.float32)
        starts = window_starts(len(audio), self.config.window_sec,
                               self.config.hop_sec)
        if self._frame_reuse and len(audio) >= self._win:
            # pow2-bucketed frame count, as the JAX engine pads it
            needed = int(starts[-1]) + self._win
            n_true_frames = F.num_frames(needed)
            n_frames_padded = _next_pow2(n_true_frames)
            padded_len = (n_frames_padded - 1) * F.HOP_LENGTH + F.FRAME_LENGTH
            device_buf = self._cached_or_computed_frames(
                audio, path, padded_len, n_true_frames, n_frames_padded)
            return "frames", device_buf, starts // F.HOP_LENGTH
        # zero-pad so every gathered window is in bounds; pow2 samples
        padded_len = int(starts[-1]) + self._win
        buf = np.zeros(_next_pow2(padded_len, floor=self._win), audio.dtype)
        # audio may exceed the bucketed buffer (trailing samples past
        # starts[-1]+win are never windowed)
        m = min(len(audio), len(buf))
        buf[:m] = audio[:m]
        return "samples", torch.from_numpy(buf).to(self.device), starts

    def _cached_or_computed_frames(self, audio, path, padded_len,
                                   n_true_frames, n_frames_padded):
        """File-level raw log-mel frames on the device, via the cache when
        enabled."""
        from . import cache as fcache

        cfg = self.config
        use_cache = (cfg.cache_dir is not None and path is not None
                     and os.path.exists(path))
        if use_cache and not cfg.refresh_cache:
            hit = fcache.load_frames(path, cfg.window_sec, cfg.hop_sec,
                                     SAMPLING_RATE, cfg.cache_dir)
            if hit is not None and hit.shape[0] >= n_true_frames:
                # stderr: stdout is reserved for the CLI's JSON output
                print(f"[cache] hit for {os.path.basename(path)}",
                      file=sys.stderr)
                padded = np.zeros((n_frames_padded, F.NUM_MEL_BINS),
                                  np.float32)
                padded[:n_true_frames] = hit[:n_true_frames]
                return torch.from_numpy(padded).to(self.device)

        buf = np.zeros(padded_len, audio.dtype)
        m = min(len(audio), padded_len)
        buf[:m] = audio[:m]
        frames = F.logmel_frames(torch.from_numpy(buf).to(self.device),
                                 F.num_frames(padded_len),
                                 front_end=self.front_end)
        if use_cache and (self.mesh is None or pmesh.is_main(self.mesh)):
            fcache.save_frames(path, frames[:n_true_frames].cpu().numpy(),
                               cfg.window_sec, cfg.hop_sec, SAMPLING_RATE,
                               cfg.cache_dir)
        return frames

    def _run_stage(self, stage: int, kind: str, device_buf: torch.Tensor,
                   starts: np.ndarray) -> np.ndarray:
        """Run one stage over all `starts` in fixed-size chunks.

        Every chunk is queued before any result is fetched, and the starts
        of all chunks go to the device in one copy before the first, so the
        host never waits on the device between chunks. Tail chunks are
        padded up to pow2 buckets with start 0 (always in range; rows
        discarded), as in the JAX engine. With a mesh each rank runs its
        contiguous share of every chunk (the buckets' floor is the mesh
        size, so each divides), and one gather at the end puts the rows
        back in window order. The queueing is the `cascade.stage<n>` span,
        the fetch `cascade.fetch`."""
        with span(f"cascade.stage{stage}"):
            pending = self._queue_stage(stage, kind, device_buf, starts)
        with span("cascade.fetch"):
            if self.mesh is not None:
                pending = self._gather_chunks(pending)
            return np.concatenate(
                [p[:n].cpu().numpy().astype(np.float64) for n, p in pending])

    def _queue_stage(self, stage: int, kind: str, device_buf: torch.Tensor,
                     starts: np.ndarray) -> list:
        """(valid rows, probabilities on the device) of each chunk of one
        stage, all queued (this rank's share of each with a mesh)."""
        C = self.config.batch_size
        W = len(starts)
        floor = 8
        if self.mesh is not None:
            floor = pmesh.mesh_size(self.mesh)
        sizes = []  # (valid rows, bucket) of each chunk
        i = 0
        while i < W:
            n = min(C, W - i)
            sizes.append((n, C if n == C else min(C, _next_pow2(n,
                                                                floor=floor))))
            i += n
        padded = np.zeros(sum(b for _, b in sizes), np.int64)
        i = j = 0
        for n, bucket in sizes:
            padded[j: j + n] = starts[i: i + n]
            i += n
            j += bucket
        padded = torch.from_numpy(padded).to(self.device)
        pending = []
        j = 0
        for n, bucket in sizes:
            chunk = padded[j: j + bucket]
            if self.mesh is not None:
                chunk = pmesh.local_rows(chunk, self.mesh)
            probs = self._stage_probs(stage, kind, device_buf, chunk)
            pending.append((n, probs))
            j += bucket
        return pending

    def _gather_chunks(self, pending):
        """Every rank's share of every chunk -> the chunks' whole rows, in
        one collective: the ranks' concatenated shares are gathered, then
        each chunk's shares are laid rank after rank."""
        n_dev = pmesh.mesh_size(self.mesh)
        local = torch.cat([p for _, p in pending])
        glob = pmesh.gather_rows(local, self.mesh).view(
            n_dev, local.shape[0], -1)
        out = []
        off = 0
        for n, p in pending:
            b = p.shape[0]
            out.append((n, glob[:, off: off + b].reshape(n_dev * b, -1)))
            off += b
        return out

    # ---------------- reference-exact gating & summaries ----------------

    def gate_and_summarize(self, s1_probs: np.ndarray, s2_probs: np.ndarray):
        """Apply the reference's two-stage gating to all-window probs.

        Returns (summary dict, s1_preds, stage2_results, stage2_aligned_classes)
        exactly as src/test_long_audio_windows_2stage_cache.py:455-538 computes
        them."""
        cfg = self.config
        p_swallow = s1_probs[:, 1]
        s1_preds = s1_probs.argmax(axis=1)
        s1_preds = np.where((s1_preds == 1) & (p_swallow >= cfg.stage1_threshold), 1, 0)

        # same gate that selected the stage-2 evaluations in window_probs
        swallow_indices = self._gate_indices(s1_probs)
        stage2_results = [(int(g), s2_probs[g]) for g in swallow_indices]

        aligned_classes = np.full(len(s1_preds), -1, dtype=int)
        for gidx, probs in stage2_results:
            if cfg.stage2_argmax:
                aligned_classes[gidx] = int(np.argmax(probs))
            else:
                aligned_classes[gidx] = 1 if probs[1] >= cfg.stage2_threshold else 0

        summary = summarize_stage_outputs(
            s1_probs, stage2_results,
            list(self.stage1.label_order), list(self.stage2.label_order),
            cfg.stage2_threshold, cfg.stage2_argmax,
        )
        return summary, s1_preds, stage2_results, aligned_classes

    def infer_file(self, audio: np.ndarray, path: str = "") -> dict:
        with span("cascade.recording"):
            s1_probs, s2_probs = self.window_probs(audio, path or None)
            with span("cascade.summary"):
                summary, s1_preds, _, aligned = self.gate_and_summarize(
                    s1_probs, s2_probs)
                return {
                    "path": path,
                    **summary,
                    "_s1_preds": s1_preds,
                    "_stage2_aligned_classes": aligned,
                    "_s1_probs": s1_probs,
                    "_s2_probs": s2_probs,
                }

    def run_patient(self, files: Sequence[str], audios: Sequence[np.ndarray],
                    stage1_model_root: str = "", stage2_model_root: str = "") -> dict:
        """Full per-patient output, JSON-schema compatible with the
        reference's `outputs/<pid>_2stage.json`
        (src/test_long_audio_windows_2stage.py:360-410)."""
        per_file = {}
        for idx, (path, audio) in enumerate(zip(files, audios)):
            res = self.infer_file(audio, path)
            per_file[f"file_{idx}"] = {
                k: v for k, v in res.items() if not k.startswith("_")
            }
        with span("cascade.summary"):
            return build_patient_output(self.config, files, per_file,
                                        stage1_model_root, stage2_model_root)


def build_patient_output(cfg: CascadeConfig, files: Sequence[str],
                         per_file: dict,
                         stage1_model_root: str = "",
                         stage2_model_root: str = "") -> dict:
    """Assemble the per-patient JSON (config/per_file/aggregate) from
    per-file summaries — the single definition of the output schema
    (reference src/test_long_audio_windows_2stage.py:360-410), shared by
    TwoStageEngine.run_patient and cli/infer_long_audio."""
    vals = per_file.values()
    total_windows = sum(f["num_windows"] for f in vals)
    total_idle = sum(f["stage1_idle_windows"] for f in vals)
    total_swallow = sum(f["stage1_swallow_windows"] for f in vals)
    total_eval = sum(f["stage2_swallow_windows_evaluated"] for f in vals)
    total_healthy = sum(f["stage2_healthy_windows"] for f in vals)
    total_zenker = sum(f["stage2_zenker_windows"] for f in vals)
    aggregate = {
        "files_used": list(files),
        "total_windows": int(total_windows),
        "total_idle_windows": int(total_idle),
        "total_swallow_windows": int(total_swallow),
        "total_swallow_ratio": total_swallow / max(1, total_windows),
        "total_swallow_windows_evaluated_stage2": int(total_eval),
        "total_healthy_windows": int(total_healthy),
        "total_zenker_windows": int(total_zenker),
        "overall_zenker_ratio_over_swallow": (total_zenker / total_swallow)
        if total_swallow else None,
    }
    return {
        "config": {
            "stage1_model_root": stage1_model_root,
            "stage2_model_root": stage2_model_root,
            "window_sec": cfg.window_sec,
            "hop_sec": cfg.hop_sec,
            "batch_size": cfg.batch_size,
            "stage1_threshold": cfg.stage1_threshold,
            "files": list(files),
        },
        "per_file": per_file,
        "aggregate": aggregate,
    }


def summarize_stage_outputs(
    stage1_probs: np.ndarray,
    stage2_probs_or_none: list[tuple[int, np.ndarray]],
    stage1_label_order: list[str],
    stage2_label_order: list[str],
    stage2_threshold: float = 0.5,
    use_argmax: bool = False,
) -> dict:
    """Byte-for-byte replication of the reference summary
    (src/test_long_audio_windows_2stage_cache.py:243-301): note the counts
    use raw argmax predictions, NOT the thresholded ones."""
    stage1_preds = stage1_probs.argmax(axis=1)
    stage2_aligned: list[np.ndarray | None] = [None] * len(stage1_preds)
    for idx, probs in stage2_probs_or_none:
        stage2_aligned[idx] = probs
    idle_count = int((stage1_preds == 0).sum())
    swallow_count = int((stage1_preds == 1).sum())

    evaluated = [p for p in stage2_aligned if p is not None]
    if use_argmax:
        healthy_count = int(sum(1 for p in evaluated if np.argmax(p) == 0))
        zenker_count = int(sum(1 for p in evaluated if np.argmax(p) == 1))
    else:
        healthy_count = int(sum(1 for p in evaluated if p[1] < stage2_threshold))
        zenker_count = int(sum(1 for p in evaluated if p[1] >= stage2_threshold))

    return {
        "num_windows": int(len(stage1_preds)),
        "stage1_idle_windows": idle_count,
        "stage1_swallow_windows": swallow_count,
        "stage1_swallow_ratio": (swallow_count / len(stage1_preds))
        if len(stage1_preds) else 0.0,
        "stage1_mean_probs": stage1_probs.mean(axis=0).tolist()
        if len(stage1_probs) else None,
        "stage2_mean_probs_over_swallow": np.mean(evaluated, axis=0).tolist()
        if swallow_count else None,
        "stage2_swallow_windows_evaluated": int(len(evaluated)),
        "stage2_healthy_windows": healthy_count,
        "stage2_zenker_windows": zenker_count,
        "stage2_zenker_ratio_over_swallow": (zenker_count / swallow_count)
        if swallow_count else None,
    }
