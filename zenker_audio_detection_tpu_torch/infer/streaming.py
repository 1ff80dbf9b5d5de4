"""Real-time streaming two-stage cascade, in PyTorch.

Port of the JAX package's `infer/streaming.py`. Audio arrives in chunks of
any size (a microphone buffer, a network stream) and per-window
probabilities are emitted with bounded latency, numerically matching the
offline engine (`infer/cascade.py:TwoStageEngine`).

- **Log-mel ring on the engine's device.** Frames are computed on the
  device in pow2 blocks (floor 64) as samples arrive and written into a
  fixed-capacity ring `(capacity_frames, 128)` f32 modulo its capacity;
  windows are gathered from the ring with modular indices, so every read
  is in range by construction (CUDA asserts on an out-of-range index where
  JAX's gather clamps). Raw audio crosses to the device once (int16 is
  scaled there); only (B, 2) probabilities come back. Overlapping
  1 s / 0.5 s windows share 48 of 98 frames, as offline.
- **Pow2 window buckets** (floor 8): a batch of windows is padded to the
  next power of two, as offline tail chunks are, so the kernels see a
  bounded set of shapes.
- **Same numerics as offline.** The frames are `ops.fbank.logmel_frames`
  with the engine's front end, and the stage body is the engine's own
  `_classify` (pad-then-normalize, the stage's model (AST or BEATs) with
  the engine's committed params, dtype, attention route and int8 leaves,
  the softmax); the gate is the engine's `_gate_indices`.
  After `flush()`, `stage1_probs()`/`stage2_probs()` equal
  `TwoStageEngine.window_probs` on the concatenated audio.

Latency: a batch is dispatched once `chunk_windows` new windows complete
(or on `flush`); with the 0.5 s hop the added buffering is
`chunk_windows / 2` seconds of audio plus one cascade round trip.

Each StreamingCascade serves one stream on its engine's device. N streams
on N cards: one engine and stream per `cuda:N`, each on its own thread
(host work interleaves under the GIL, the cards compute concurrently).
The hop must sit on the 10 ms frame grid (the engine's frame-reuse
condition); off-grid hops are refused, the offline engine handles them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import fbank as F
from . import cascade as C


@dataclasses.dataclass(frozen=True)
class StreamResult:
    """One emitted window: absolute index, start sample, and probabilities.

    ``s2_probs`` is all-zero when the window did not pass the Stage-1 gate
    in gated mode, the offline engine's convention for the rows the
    reference never computes."""

    window_index: int
    start_sample: int
    s1_probs: np.ndarray
    s2_probs: np.ndarray


_next_pow2 = C._next_pow2


class StreamingCascade:
    """Incremental wrapper around one :class:`TwoStageEngine`.

    ``retain_results=False`` drops per-window history after emission (the
    summary is kept in O(1) running accumulators instead), as indefinite
    live streams need."""

    def __init__(self, engine: C.TwoStageEngine, chunk_windows: int = 32,
                 capacity_frames: int = 4096, retain_results: bool = True):
        if engine.mesh is not None:
            raise NotImplementedError(
                "streaming is single-device (latency-oriented); use the "
                "batch engine for multi-device serving")
        if engine._hop <= 0 or engine._win <= 0:
            raise ValueError("window_sec and hop_sec must be > 0")
        if engine._hop % F.HOP_LENGTH != 0:
            raise ValueError(
                f"streaming requires the hop ({engine._hop} samples) on the "
                f"{F.HOP_LENGTH}-sample fbank frame grid")
        if chunk_windows < 1:
            raise ValueError("chunk_windows must be >= 1")
        self.engine = engine
        self.chunk_windows = chunk_windows
        self._hop_frames = engine._hop // F.HOP_LENGTH
        self._fpw = engine._frames_per_window
        # worst-case frames touched by one emit batch: its windows span
        # (count-1)*hop + fpw frames, and the frame block computed for it
        # is bucket-padded; both must fit the ring (so a block's ring rows
        # are distinct and no window reads a row overwritten by its batch)
        worst = chunk_windows * self._hop_frames + self._fpw
        self._block_floor = 64
        if _next_pow2(worst, self._block_floor) > capacity_frames:
            raise ValueError(
                f"capacity_frames={capacity_frames} too small for "
                f"chunk_windows={chunk_windows} (need >= "
                f"{_next_pow2(worst, self._block_floor)})")
        self._cap = capacity_frames
        self._ring = torch.zeros((capacity_frames, F.NUM_MEL_BINS),
                                 dtype=torch.float32, device=engine.device)
        # host-side state
        self._stash = np.zeros(0, np.float32)  # samples not yet framed
        self._stash_offset = 0  # absolute sample index of stash[0]
        self._total_samples = 0
        self._next_frame = 0  # next absolute frame index to compute
        self._next_window = 0  # next absolute window index to emit
        self._retain = retain_results
        self._results: list[StreamResult] = []
        # O(1) running accumulators mirroring summarize_stage_outputs
        # (counts use raw argmax, the reference quirk, while stage-2
        # evaluation follows the thresholded gate)
        self._acc = {
            "n": 0, "idle": 0, "swallow": 0,
            "s1_sum": np.zeros(2, np.float64),
            "eval_count": 0, "s2_sum": np.zeros(2, np.float64),
            "healthy": 0, "zenker": 0,
        }
        self._flushed = False

    # ---------------- device work ----------------

    def _frames(self, span: np.ndarray, block: int) -> torch.Tensor:
        """`block` log-mel frames of a (block + 2) * HOP_LENGTH sample span
        (the layout `logmel_frames` frames by hop slices), on the device."""
        return F.logmel_frames(torch.from_numpy(span).to(self.engine.device),
                               block, front_end=self.engine.front_end)

    def _update(self, new: torch.Tensor, start: int, n_valid: int) -> None:
        """Write the first `n_valid` rows of `new` into the ring at
        absolute frame `start` (mod capacity); the bucket padding past
        `n_valid` leaves the ring's old rows as they are."""
        idx = (start + torch.arange(n_valid, device=self._ring.device)) \
            % self._cap
        self._ring.index_copy_(0, idx, new[:n_valid])

    def _stage(self, stage: int, starts: torch.Tensor) -> torch.Tensor:
        """(B, 2) probabilities of the windows starting at ring frames
        `starts`: the engine's stage body on a modular gather."""
        offs = torch.arange(self._fpw, device=starts.device)
        raw = self._ring[(starts[:, None] + offs[None, :]) % self._cap]
        return self.engine._classify(stage, raw)

    @torch.inference_mode()
    def warmup(self) -> None:
        """Run every device path the live feed loop can hit before traffic:
        each frame-block size in both sample dtypes, the ring write and
        each window bucket of both stages, on dummy data. On the card this
        builds and loads the kernels and warms cuBLAS and the allocator, so
        the first live emit pays none of it (an end-of-stream flush tail
        may still meet a smaller block). The ring's contents are left as
        they are: the dummy write has no valid rows."""
        hop_f, fpw = self._hop_frames, self._fpw
        # frame blocks: the first emit computes (chunk-1)*hop+fpw frames,
        # steady-state emits chunk*hop; flush tails reuse smaller blocks
        blocks = set()
        for n_new in {(self.chunk_windows - 1) * hop_f + fpw,
                      self.chunk_windows * hop_f, hop_f, fpw}:
            blocks.add(_next_pow2(max(1, n_new), self._block_floor))
        for block in sorted(blocks):
            for dt in (np.float32, np.int16):
                frames = self._frames(
                    np.zeros((block + 2) * F.HOP_LENGTH, dt), block)
            self._update(frames, 0, 0)
        # window buckets: full batches, flush tails and gated subsets all
        # land on pow2 buckets in [8, next_pow2(chunk_windows)]
        bucket = 8
        buckets = {8}
        while bucket < self.chunk_windows:
            bucket *= 2
            buckets.add(bucket)
        for bucket in sorted(buckets):
            starts = torch.zeros(bucket, dtype=torch.int64,
                                 device=self.engine.device)
            for stage in (1, 2):
                self._stage(stage, starts).cpu()

    # ---------------- host orchestration ----------------

    def feed(self, samples: np.ndarray) -> list[StreamResult]:
        """Append audio (float32 or int16 PCM @16 kHz, any length, including
        empty) and return windows that completed, in order."""
        if self._flushed:
            raise RuntimeError("feed() after flush()")
        samples = np.asarray(samples)
        if samples.ndim != 1:
            raise ValueError("samples must be 1-D")
        if samples.dtype != np.int16:
            samples = samples.astype(np.float32)
        if len(samples):
            if len(self._stash) == 0:
                self._stash = samples.copy()
            elif self._stash.dtype == samples.dtype:
                self._stash = np.concatenate([self._stash, samples])
            else:
                # mixed int16/float32 chunks: int16 means raw PCM, so the
                # cast to float applies the 1/32768 scale the device path
                # would have applied (ops/fbank.py logmel_frames)
                def to_f32(x):
                    return (x.astype(np.float32) / 32768.0
                            if x.dtype == np.int16 else x)

                self._stash = np.concatenate([to_f32(self._stash),
                                              to_f32(samples)])
            self._total_samples += len(samples)

        win, hop = self.engine._win, self.engine._hop
        n_avail = (0 if self._total_samples < win
                   else (self._total_samples - win) // hop + 1)
        emitted: list[StreamResult] = []
        while n_avail - self._next_window >= self.chunk_windows:
            emitted.extend(self._emit(self.chunk_windows))
        return emitted

    def flush(self) -> list[StreamResult]:
        """Emit all remaining complete windows. For inputs shorter than one
        window, emits the single zero-padded window the offline path
        produces (src/test_long_audio_windows_2stage.py:62-75)."""
        if self._flushed:
            return []
        self._flushed = True
        win, hop = self.engine._win, self.engine._hop
        emitted: list[StreamResult] = []
        if self._total_samples < win:
            # zero-pad to one full window, exactly like window_audio()
            pad = win - self._total_samples
            if pad:
                zeros = np.zeros(pad, self._stash.dtype if len(self._stash)
                                 else np.float32)
                self._stash = (np.concatenate([self._stash, zeros])
                               if len(self._stash) else zeros)
                self._total_samples += pad
            n_remaining = 1
        else:
            n_avail = (self._total_samples - win) // hop + 1
            n_remaining = n_avail - self._next_window
        while n_remaining > 0:
            count = min(n_remaining, self.chunk_windows)
            emitted.extend(self._emit(count))
            n_remaining -= count
        return emitted

    @torch.inference_mode()
    def _emit(self, count: int) -> list[StreamResult]:
        hop_f, fpw = self._hop_frames, self._fpw
        first_w = self._next_window
        f_end = (first_w + count - 1) * hop_f + fpw

        # 1. compute the new frames [next_frame, f_end) in one bucket block
        n_new = f_end - self._next_frame
        if n_new > 0:
            block = _next_pow2(n_new, self._block_floor)
            span_len = (block + 2) * F.HOP_LENGTH  # _frames_by_hop_slices pad
            span = np.zeros(span_len, self._stash.dtype)
            lo = self._next_frame * F.HOP_LENGTH - self._stash_offset
            if lo < 0:
                raise RuntimeError("stash was trimmed past the next frame")
            m = min(len(self._stash) - lo, span_len)
            if m > 0:
                span[:m] = self._stash[lo: lo + m]
            self._update(self._frames(span, block),
                         self._next_frame % self._cap, n_new)
            self._next_frame = f_end
            # trim the stash: frames >= f_end start at sample f_end*160;
            # keep from there on (the frame overlap needs the 240-sample
            # tail, which starting at f_end*160 always includes)
            keep_from = self._next_frame * F.HOP_LENGTH - self._stash_offset
            if keep_from > 0:
                self._stash = self._stash[keep_from:]
                self._stash_offset += keep_from

        # 2. stage 1 on the batch (bucket-padded), then the gate, then
        # stage 2. Starts are reduced mod capacity on the host, so absolute
        # frame indices stay small however long the stream runs
        # ((start % cap + off) % cap == (start + off) % cap).
        starts = (np.arange(first_w, first_w + count, dtype=np.int64)
                  * hop_f) % self._cap
        if self.engine.config.stage2_mode == "all":
            # both stages queued back to back, one fetch round trip
            padded = self._padded_starts(starts)
            d1 = self._stage(1, padded)
            d2 = self._stage(2, padded)
            p1 = self._fetch(d1, count)
            p2 = self._fetch(d2, count)
        else:
            p1 = self._fetch(self._stage(1, self._padded_starts(starts)),
                             count)
            p2 = np.zeros((count, 2), np.float64)
            gated = self.engine._gate_indices(p1)
            if len(gated):
                p2[gated] = self._fetch(
                    self._stage(2, self._padded_starts(starts[gated])),
                    len(gated))

        self._accumulate(p1, p2)
        out = []
        for i in range(count):
            r = StreamResult(first_w + i, (first_w + i) * self.engine._hop,
                             p1[i], p2[i])
            out.append(r)
            if self._retain:
                self._results.append(r)
        self._next_window += count
        return out

    def _padded_starts(self, starts: np.ndarray) -> torch.Tensor:
        """`starts` padded with ring frame 0 (always in range; the rows are
        dropped) to their pow2 bucket (floor 8), on the device."""
        bucket = _next_pow2(len(starts), floor=8)
        padded = np.zeros(bucket, np.int64)
        padded[:len(starts)] = starts
        return torch.from_numpy(padded).to(self.engine.device)

    @staticmethod
    def _fetch(probs: torch.Tensor, n: int) -> np.ndarray:
        return probs[:n].cpu().numpy().astype(np.float64)

    def _accumulate(self, p1: np.ndarray, p2: np.ndarray) -> None:
        """Fold one emitted batch into the running summary accumulators,
        replicating summarize_stage_outputs' semantics element-wise."""
        cfg = self.engine.config
        acc = self._acc
        preds = p1.argmax(axis=1)
        acc["n"] += len(p1)
        acc["idle"] += int((preds == 0).sum())
        acc["swallow"] += int((preds == 1).sum())
        acc["s1_sum"] += p1.sum(axis=0)
        gated = self.engine._gate_indices(p1)
        if len(gated):
            s2 = p2[gated]
            acc["eval_count"] += len(gated)
            acc["s2_sum"] += s2.sum(axis=0)
            if cfg.stage2_argmax:
                z = (s2.argmax(axis=1) == 1)
            else:
                z = (s2[:, 1] >= cfg.stage2_threshold)
            acc["zenker"] += int(z.sum())
            acc["healthy"] += int((~z).sum())

    # ---------------- offline-compatible views ----------------

    def stage1_probs(self) -> np.ndarray:
        if not self._retain:
            raise RuntimeError(
                "per-window history not kept with retain_results=False "
                "(use the emitted StreamResults, or summary())")
        return (np.stack([r.s1_probs for r in self._results])
                if self._results else np.zeros((0, 2), np.float64))

    def stage2_probs(self) -> np.ndarray:
        if not self._retain:
            raise RuntimeError(
                "per-window history not kept with retain_results=False "
                "(use the emitted StreamResults, or summary())")
        return (np.stack([r.s2_probs for r in self._results])
                if self._results else np.zeros((0, 2), np.float64))

    @property
    def windows_emitted(self) -> int:
        """Number of windows emitted so far (== the next local window
        index): the serve handoff protocol's resume point."""
        return self._next_window

    def acc_state(self) -> dict:
        """JSON-able snapshot of the running summary accumulators.

        With :meth:`seed_accumulators` this carries the summary across
        processes: a recycled server (``cli.serve --handoff``,
        ``cli.serve_supervisor``) hands its accumulators to its successor,
        whose final :meth:`summary` then covers the whole stream bit for
        bit (``json`` round-trips float64 exactly)."""
        acc = self._acc
        return {
            "n": int(acc["n"]), "idle": int(acc["idle"]),
            "swallow": int(acc["swallow"]),
            "s1_sum": [float(x) for x in acc["s1_sum"]],
            "eval_count": int(acc["eval_count"]),
            "s2_sum": [float(x) for x in acc["s2_sum"]],
            "healthy": int(acc["healthy"]), "zenker": int(acc["zenker"]),
        }

    def seed_accumulators(self, state: dict) -> None:
        """Seed the summary accumulators from a prior :meth:`acc_state`
        snapshot (process-recycle handoff), before any audio is fed."""
        if self._next_window or self._total_samples:
            raise RuntimeError("seed_accumulators() on a started stream")
        missing = set(self._acc) - set(state)
        if missing:
            raise ValueError(f"acc state missing keys: {sorted(missing)}")
        for k in ("n", "idle", "swallow", "eval_count", "healthy", "zenker"):
            self._acc[k] = int(state[k])
        for k in ("s1_sum", "s2_sum"):
            arr = np.asarray(state[k], np.float64)
            if arr.shape != (2,):
                raise ValueError(f"acc state {k} must have shape (2,)")
            self._acc[k] = arr

    def summary(self) -> dict:
        """Reference-exact per-file summary over everything emitted so far
        (the offline engine's gate_and_summarize), O(1) from the running
        accumulators."""
        acc = self._acc
        n, swallow = acc["n"], acc["swallow"]
        evaluated = acc["eval_count"]
        if not swallow:
            s2_mean = None
        elif evaluated:
            s2_mean = (acc["s2_sum"] / evaluated).tolist()
        else:
            # summarize_stage_outputs hits np.mean([]) here: scalar NaN
            s2_mean = float("nan")
        return {
            "num_windows": int(n),
            "stage1_idle_windows": int(acc["idle"]),
            "stage1_swallow_windows": int(swallow),
            "stage1_swallow_ratio": (swallow / n) if n else 0.0,
            "stage1_mean_probs": (acc["s1_sum"] / n).tolist() if n else None,
            "stage2_mean_probs_over_swallow": s2_mean,
            "stage2_swallow_windows_evaluated": int(evaluated),
            "stage2_healthy_windows": int(acc["healthy"]),
            "stage2_zenker_windows": int(acc["zenker"]),
            "stage2_zenker_ratio_over_swallow": (acc["zenker"] / swallow)
            if swallow else None,
        }
