"""Build and load the port's CUDA kernels.

Each source under ``csrc/`` is compiled with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. The build happens at first use, into ``build/torch_kernels/`` at
the repository root, and is keyed by a hash of the source, the headers it
includes from ``csrc/`` and the flags, so an edited source or header is
rebuilt and an unchanged one is loaded as it is.
Nothing is compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C entry points of each source: name -> (pointer arguments, int
# arguments, whether a stream follows). A kernel's entry point takes
# (void*..., int..., void* stream); every entry point returns an int, a
# cudaError_t for a launch.
_DTYPES = ("bf16", "f32")


def _walks(names: list[str]) -> dict:
    """The entry points of the persistent walks' sources: per name (with
    its dtype) the launch, whose lse forward also takes the lse buffer, and
    the instance's CTAs per SM (D, threads, smem)."""
    return {**{name: (5 if "_lse_" in name else 4, 9, True)
               for name in names},
            **{name.replace("_bf16", "_occupancy_bf16")
               .replace("_f32", "_occupancy_f32"): (0, 3, False)
               for name in names}}


# mha_packed's function on the same memory: the walks' own instances
_SAME_AS_PACKED = ("mha_packed", "mha_packed_lse", "mha", "mha_pairs",
                   "mha_qblock")
_ENTRY_POINTS = {
    # the launches (q, k, v, ... and B, S, NH, D, grid, threads, smem), and
    # the CTAs per SM of the bf16 walk's instances
    "attention_bwd": {
        **{f"mha_packed_bwd_{part}_{dtype}": (8, 9, True)
           for part in ("dq", "dkdv") for dtype in _DTYPES},
        **{f"mha_packed_bwd_{part}_occupancy_bf16": (0, 3, False)
           for part in ("dq", "dkdv")}},
    "attention_pipelined": _walks(
        [f"{fn}_{dtype}" for fn in ("mha_batched_heads", "mha_fused")
         for dtype in _DTYPES] + [f"{fn}_f32" for fn in _SAME_AS_PACKED]),
    "attention_ws": {
        **_walks([f"{fn}_bf16" for fn in _SAME_AS_PACKED]),
        # BEATs's attention: q, k, v, o, gate and rel
        "mha_packed_relpos_bf16": (6, 9, True),
        "mha_packed_relpos_occupancy_bf16": (0, 3, False)},
}
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin directory on PATH)")


def _sources(name: str) -> list[Path]:
    """``csrc/<name>.cu`` and every file of ``csrc/`` it includes with
    ``#include "..."``, directly or through another, in the order met."""
    found, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in found:
            continue
        found.append(path)
        todo += [CSRC / inc for inc in _INCLUDE.findall(path.read_text())]
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources(name):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    Returns (library path, seconds spent compiling; 0.0 when it was built).
    The compiler's report (registers, shared memory, spills) is kept beside
    the library as ``<library>.log``."""
    lib = library_path(name)
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # per process and thread: engines on several threads (one per card)
    # may build the same library at once
    tmp = lib.with_suffix(f".tmp{os.getpid()}_{threading.get_ident()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    lib.with_suffix(".so.log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib, seconds


def build_all() -> dict[str, float]:
    """Build every kernel source at once, one ``nvcc`` per source; returns
    the compile seconds of each."""
    with ThreadPoolExecutor(max_workers=len(_ENTRY_POINTS)) as pool:
        results = dict(zip(_ENTRY_POINTS, pool.map(build, _ENTRY_POINTS)))
    return {name: seconds for name, (_, seconds) in results.items()}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = ctypes.CDLL(str(build(name)[0]))
    for fn_name, (n_ptr, n_int, stream) in _ENTRY_POINTS[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p] * stream)
        fn.restype = ctypes.c_int
    return lib
