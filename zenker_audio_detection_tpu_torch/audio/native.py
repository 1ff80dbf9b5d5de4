"""ctypes binding to the native audio library (decode, resample, vocoder).

The port's own binding to the C++ sources in the repository's `native/`
directory (`audioio.cpp`: WAV decode and the polyphase resampler;
`vocoder.cpp`: the STFT phase-vocoder time stretch), with the JAX package's
`audio/native.py` API. The numerics are the Python paths' (`audio/io.py`,
`ops/resample.py`, `data/augment.py`), which stay as their oracles.

The library is built at first use (`available()`, or any function here),
never when this module is imported: `g++` with `native/Makefile`'s flags
(`-ffast-math` for `vocoder.cpp` only) into `build/native/` at the
repository root, keyed by a hash of both sources and the flags, under a
file lock, since several processes may ask for it at once. Nothing is
built into or read from `native/` itself. When the build fails,
`available()` says why once on stderr and returns False, and every
function here returns None, so callers take the Python path.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys
import tempfile
import threading
from pathlib import Path

import numpy as np

REPO_DIR = Path(__file__).resolve().parent.parent.parent
NATIVE_SRC = REPO_DIR / "native"
BUILD_DIR = REPO_DIR / "build" / "native"
CXX = "g++"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native",
            "-fopenmp")
# the vocoder's sincos/atan2/hypot vectorize under -ffast-math; the decoder
# and the resampler keep strict math (native/Makefile)
SOURCES = {"audioio.cpp": CXXFLAGS, "vocoder.cpp": CXXFLAGS + ("-ffast-math",)}
# at or below n_fft // 2 samples numpy's "reflect" pad reflects more than
# once (and zero-pads below), which the C++ single reflection does not do
_VOCODER_MIN_LEN = 1024

_lock = threading.Lock()
_state: dict = {}  # "lib": the CDLL or None, once the first use has run


def library_path() -> Path:
    """Where the library built from the current sources and flags lives."""
    digest = hashlib.sha256()
    for name, flags in SOURCES.items():
        digest.update(" ".join((CXX,) + flags).encode() + b"\0")
        digest.update((NATIVE_SRC / name).read_bytes())
    return BUILD_DIR / f"libaudioio_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the library unless it is built; returns its path.
    Raises RuntimeError with the compiler's message when a step fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if lib.exists():  # another process built it meanwhile
            return lib
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objects = []
            for name, flags in SOURCES.items():
                obj = os.path.join(tmp, name.replace(".cpp", ".o"))
                _run([CXX, *flags, "-c", "-o", obj, str(NATIVE_SRC / name)])
                objects.append(obj)
            staged = os.path.join(tmp, lib.name)
            _run([CXX, *CXXFLAGS, "-shared", "-o", staged, *objects])
            os.replace(staged, lib)
    return lib


def _run(cmd: list[str]) -> None:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:  # no compiler
        raise RuntimeError(f"{cmd[0]}: {exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed (exit "
                           f"{proc.returncode}):\n{proc.stderr}")


def _bind(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    c_int_p = ctypes.POINTER(ctypes.c_int)
    c_ll_p = ctypes.POINTER(ctypes.c_longlong)
    c_float_p = ctypes.POINTER(ctypes.c_float)
    c_double_p = ctypes.POINTER(ctypes.c_double)
    signatures = {
        "audioio_wav_info": ([ctypes.c_char_p, c_int_p, c_int_p, c_ll_p],
                             ctypes.c_int),
        "audioio_read_mono": ([ctypes.c_char_p, c_float_p, ctypes.c_longlong,
                               c_int_p], ctypes.c_int),
        "audioio_read_mono_v2": ([ctypes.c_char_p, c_float_p,
                                  ctypes.c_longlong, c_int_p, c_ll_p],
                                 ctypes.c_int),
        "audioio_resampled_length": ([ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_int], ctypes.c_longlong),
        "audioio_resample": ([c_float_p, ctypes.c_longlong, ctypes.c_int,
                              ctypes.c_int, c_float_p], ctypes.c_int),
        "audioio_stretch_out_length": ([ctypes.c_longlong, ctypes.c_double],
                                       ctypes.c_longlong),
        "audioio_phase_vocoder_stretch": ([c_double_p, ctypes.c_longlong,
                                           ctypes.c_double, c_double_p],
                                          ctypes.c_int),
    }
    for name, (argtypes, restype) in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def load_library() -> ctypes.CDLL | None:
    """The loaded library, built first if needed; None when it cannot be
    built or loaded (the reason is printed once on stderr)."""
    with _lock:
        if "lib" not in _state:
            try:
                _state["lib"] = _bind(build())
            except (RuntimeError, OSError) as exc:
                print(f"[audio.native] native audio library unavailable, "
                      f"using the Python path: {exc}", file=sys.stderr)
                _state["lib"] = None
        return _state["lib"]


def available() -> bool:
    return load_library() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def read_mono(path: str) -> tuple[np.ndarray, int] | None:
    """Decoded mono (channel-mean) float32 waveform and its rate, or None
    when the library is unavailable or the file is not a WAV it reads."""
    lib = load_library()
    if lib is None:
        return None
    ch, sr, nf = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    if lib.audioio_wav_info(path.encode(), ctypes.byref(ch), ctypes.byref(sr),
                            ctypes.byref(nf)) != 0:
        return None
    out = np.empty(nf.value, dtype=np.float32)
    # the file is read again after `out` was sized: a recorder file being
    # written may have shrunk meanwhile, so keep only the decoded frames
    frames = ctypes.c_longlong()
    if lib.audioio_read_mono_v2(path.encode(), _ptr(out, ctypes.c_float),
                                nf.value, ctypes.byref(sr),
                                ctypes.byref(frames)) != 0:
        return None
    return out[: frames.value], sr.value


def resample(x: np.ndarray, orig_freq: int,
             new_freq: int) -> np.ndarray | None:
    """Native polyphase resample of a mono float32 signal; None when the
    library is unavailable or the rates are invalid (callers raise their
    own typed error)."""
    lib = load_library()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32)
    out_len = lib.audioio_resampled_length(len(x), orig_freq, new_freq)
    if out_len < 0:
        return None
    out = np.empty(out_len, dtype=np.float32)
    rc = lib.audioio_resample(_ptr(x, ctypes.c_float), len(x), orig_freq,
                              new_freq, _ptr(out, ctypes.c_float))
    return out if rc == 0 else None


def phase_vocoder_stretch(x: np.ndarray, rate: float) -> np.ndarray | None:
    """Native STFT phase-vocoder time stretch (float64), within 1e-8 of the
    numpy vocoder; None when the library is unavailable or the input has
    at most 1024 samples (that edge stays on the numpy path)."""
    lib = load_library()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    if len(x) <= _VOCODER_MIN_LEN:
        return None
    n_out = lib.audioio_stretch_out_length(len(x), float(rate))
    if n_out < 0:
        return None
    out = np.empty(n_out, dtype=np.float64)
    rc = lib.audioio_phase_vocoder_stretch(_ptr(x, ctypes.c_double), len(x),
                                           float(rate),
                                           _ptr(out, ctypes.c_double))
    return out if rc == 0 else None


def load_audio(path: str, target_sr: int = 16000) -> np.ndarray | None:
    """Native decode -> mono -> resample; None when the native path cannot
    read the file."""
    got = read_mono(path)
    if got is None:
        return None
    mono, sr = got
    if sr == target_sr:
        return mono
    return resample(mono, sr, target_sr)
