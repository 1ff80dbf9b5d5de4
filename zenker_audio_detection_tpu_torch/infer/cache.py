"""Content-addressed feature cache for long-audio inference.

A copy of the JAX package's `infer/cache.py`. Equivalent of the reference's
.pt feature cache (src/test_long_audio_windows_2stage_cache.py:84-192), with
one improvement:
what's cached is the *file-level raw (unnormalized) log-mel frame matrix*,
not per-window normalized features. Normalization is a per-stage affine
applied at load, so one cache entry serves both stages even when their
mean/std differ (the reference can only share whole-window features when the
two extractors are identical, :418-422).

Key = sha256(abs_path | window | hop | sr | fingerprint | size_mtime)[:16],
same recipe as the reference (:89-103); bundle = npz {metadata, frames},
metadata-verified before use (:168-180).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading

import numpy as np

from ..ops import fbank as F

DEFAULT_CACHE_DIR = os.path.join(".cache", "ast_features")


def fbank_fingerprint() -> str:
    """Fingerprint of the raw-frame recipe (frame/hop/fft/mel geometry).
    Normalization is intentionally excluded — it is applied after load."""
    recipe = {
        "frame_length": F.FRAME_LENGTH,
        "hop_length": F.HOP_LENGTH,
        "fft_length": F.FFT_LENGTH,
        "num_mel_bins": F.NUM_MEL_BINS,
        "preemphasis": F.PREEMPHASIS,
        "mel_floor": F.MEL_FLOOR,
        "mel_fmin": F.MEL_FMIN,
        "kind": "kaldi_logmel_raw",
    }
    return hashlib.sha256(
        json.dumps(recipe, sort_keys=True).encode()).hexdigest()


def cache_key(path: str, window_sec: float, hop_sec: float, sr: int) -> str:
    st = os.stat(path)
    payload = "|".join([
        os.path.abspath(path), f"{window_sec:.6f}", f"{hop_sec:.6f}",
        str(sr), fbank_fingerprint(), f"{st.st_size}_{st.st_mtime_ns}",
    ])
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def cache_path(path: str, window_sec: float, hop_sec: float, sr: int,
               cache_dir: str = DEFAULT_CACHE_DIR) -> str:
    base = os.path.splitext(os.path.basename(path))[0]
    digest = cache_key(path, window_sec, hop_sec, sr)
    return os.path.join(cache_dir, f"{base}_{digest}.npz")


def _metadata(path: str, window_sec: float, hop_sec: float, sr: int) -> dict:
    st = os.stat(path)
    return {
        "path": os.path.abspath(path),
        "window_sec": window_sec,
        "hop_sec": hop_sec,
        "sampling_rate": sr,
        "fingerprint": fbank_fingerprint(),
        "size": st.st_size,
        "mtime_ns": st.st_mtime_ns,
    }


def save_frames(path: str, frames: np.ndarray, window_sec: float,
                hop_sec: float, sr: int,
                cache_dir: str = DEFAULT_CACHE_DIR) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    out = cache_path(path, window_sec, hop_sec, sr, cache_dir)
    # Write-to-tmp + atomic rename: a killed job's truncated npz would
    # self-heal anyway (load_frames treats any unreadable bundle as a miss
    # and the recompute overwrites it), but concurrent servers sharing one
    # cache dir (the fleet recipe in README) can land on the same key at
    # the same time — interleaved in-place writes would corrupt the bundle
    # both of them then trust. The pid+tid suffix keeps writers disjoint
    # across processes AND threads (fold-parallel serving runs one engine
    # per fold in threads, and the cache key is fold-independent, so all
    # folds hit the same path for the same patient file).
    tmp = (f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
           ".npz")  # .npz suffix: savez appends it otherwise
    try:
        np.savez_compressed(
            tmp, frames=np.asarray(frames, np.float32),
            metadata=json.dumps(_metadata(path, window_sec, hop_sec, sr)))
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load_frames(path: str, window_sec: float, hop_sec: float, sr: int,
                cache_dir: str = DEFAULT_CACHE_DIR) -> np.ndarray | None:
    """Returns the cached raw frame matrix or None (miss / stale)."""
    p = cache_path(path, window_sec, hop_sec, sr, cache_dir)
    if not os.path.exists(p):
        return None
    try:
        with np.load(p, allow_pickle=False) as z:
            meta = json.loads(str(z["metadata"]))
            if meta != _metadata(path, window_sec, hop_sec, sr):
                return None
            return z["frames"]
    except Exception:
        return None
