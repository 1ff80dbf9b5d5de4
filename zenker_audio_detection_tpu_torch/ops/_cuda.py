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
# arguments, whether a stream follows[, float arguments]). A kernel's entry
# point takes (void*..., int..., float..., void* stream); every entry point
# returns an int, a cudaError_t for a launch.
_DTYPES = ("bf16", "f32")


def _walks(pointers: dict[str, int]) -> dict:
    """The entry points of attention kernels that report their occupancy:
    per launch symbol (with its dtype) and its pointer arguments, the
    launch (B, S, NH, D, the grid, threads and smem) and the CTAs per SM of
    the instance (D, threads, smem)."""
    return {**{name: (n_ptr, 9, True) for name, n_ptr in pointers.items()},
            **{name.replace("_bf16", "_occupancy_bf16")
               .replace("_f32", "_occupancy_f32"): (0, 3, False)
               for name in pointers}}


# one launch symbol per compiled kernel (ops/attention.py:KERNEL_OF picks
# the one an entry point launches): q, k, v, the output and the lse
# buffer, gate and rel, or the backward's operands
_ENTRY_POINTS = {
    "attention_bwd": {
        **_walks({f"mha_packed_bwd_{part}_bf16": 8
                  for part in ("dq", "dkdv")}),
        **{f"mha_packed_bwd_{part}_f32": (8, 9, True)
           for part in ("dq", "dkdv")}},
    "attention_pipelined": _walks({
        **{f"{fn}_{dtype}": 4 for fn in ("mha_batched_heads", "mha_fused")
           for dtype in _DTYPES},
        "mha_packed_lse_f32": 5}),
    "attention_ws": _walks({"mha_packed_bf16": 4, "mha_packed_lse_bf16": 5,
                            "mha_packed_relpos_bf16": 6}),
    # the AST trunk's elementwise epilogues (ops/epilogue.py): rows, width
    # and LayerNorm's eps
    "trunk_epilogue": {
        **{f"{name}_{dtype}": spec for dtype in _DTYPES
           for name, spec in (("qkv_bias", (6, 2, True)),
                              ("bias_gelu", (2, 2, True)),
                              ("residual_layer_norm", (7, 2, True, 1)),
                              ("layer_norm", (4, 2, True, 1)))}},
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
    for fn_name, (n_ptr, n_int, stream, *n_float) in \
            _ENTRY_POINTS[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * sum(n_float)
                       + [ctypes.c_void_p] * stream)
        fn.restype = ctypes.c_int
    return lib


def run(source: str, fn_name: str, tensors, ints, device) -> None:
    """Calls C entry point `fn_name` of `csrc/<source>.cu` with the tensors'
    device pointers, the ints (and floats) and the current stream of CUDA
    `device`; raises if the launch failed."""
    import torch

    fn = getattr(load(source), fn_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(x.data_ptr() for x in tensors), *ints, stream)
    if err:
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError_t "
                           f"{err}")
