#!/usr/bin/env python3
"""Times variants of csrc/attention_bwd.cu's bf16 kernels, the backward of
mha_packed_trainable, on one NVIDIA GPU.

    python3 tools/bwd_variants.py [--variants NAME ...]

Builds copies of the source with other walk shapes (its kDqConsumers,
kDkdvConsumers and kStages constexprs), with exp2f for its exponent, and
with text edits that take one piece of work out (`VARIANTS`), into
build/bwd_variants/ (one nvcc each,
in parallel), and prints their registers and spills. Each variant's
bwd_dq and bwd_dkdv run at the training shape (16, 1214, 768) bf16, 12
heads, on seeded inputs, and are held to the package's kernels (dq, delta,
dk, dv; 2e-2): a variant marked as a probe drops work the result needs,
so its difference is printed and not held. Then each is timed beside the
package's kernels, two rounds in turn, `--iters` launches queued between
two CUDA events after a warm-up (device ms per launch). Ends with the
card's name and power limit and one JSON line of the times. The source is
not changed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT_DIR = ROOT / "build" / "bwd_variants"
sys.path.insert(0, str(ROOT))
B, S, NH, D = 16, 1214, 12, 64

EX2 = ("ex2(s", "exp2f(s")
# name -> (constexpr values, [(old text, new text)], probe)
VARIANTS = {
    "base": ({}, [], False),
    "exp2f": ({}, [EX2], False),  # the mma.sync kernels' exponent
    "dq2": ({"kDqConsumers": 2}, [], False),
    "stages3": ({"kStages": 3}, [], False),
    "stages6": ({"kStages": 6}, [], False),
    "dkdv3": ({"kDkdvConsumers": 3}, [], False),
    # a probe: no exponent (p = the scaled score)
    "probe_noexp": ({}, [("ex2(s", "(s")], True),
}


def source(name: str) -> str:
    from zenker_audio_detection_tpu_torch.ops import _cuda

    consts, edits, _ = VARIANTS[name]
    src = (_cuda.CSRC / "attention_bwd.cu").read_text()
    for const, value in consts.items():
        src, n = re.subn(rf"^constexpr int {const} = \d+;",
                         f"constexpr int {const} = {value};", src,
                         flags=re.MULTILINE)
        if n != 1:
            raise SystemExit(f"no {const} constexpr in the source")
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"variant {name}: the source no longer has "
                             f"{old!r}; update the probe")
        src = src.replace(old, new)
    return src


def build(name: str) -> ctypes.CDLL:
    from zenker_audio_detection_tpu_torch.ops import _cuda

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
    cu.write_text(source(name))
    proc = subprocess.run(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{_cuda.CSRC}", "-o", str(lib),
         str(cu)], capture_output=True, text=True)
    report = proc.stdout + proc.stderr
    entry = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '.*?(\w+_ws_kernel)ILi64", line)
        if m:
            entry = m.group(1)
        elif entry and ("Used" in line or "spill" in line):
            print(f"[bwd] {name} {entry}<64>: {line.strip()}", flush=True)
        elif "Compiling entry function" in line:
            entry = None
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{report}")
    cdll = ctypes.CDLL(str(lib))
    for fn_name in ("mha_packed_bwd_dq_bf16", "mha_packed_bwd_dkdv_bf16"):
        fn = getattr(cdll, fn_name)
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return cdll


def geometry(name: str, kind: str, sms: int) -> tuple:
    """(gx, threads, smem) of variant `name`'s launch of `kind` ("dq" or
    "dkdv")."""
    text = source(name)

    def const(what):
        return int(re.search(rf"^constexpr int {what} = (\d+);", text,
                             re.MULTILINE).group(1))

    consumers = const("kDkdvConsumers" if kind == "dkdv" else "kDqConsumers")
    stages = const("kStages")
    stats = 2 * 64 * 4 if kind == "dkdv" else 0
    smem = 1024 + stages * (2 * 64 * D * 2 + stats) + 16 * stages
    items = B * NH * -(-S // (64 * consumers))
    return min(items, sms), 128 * (consumers + 1), smem


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bwd_variants: CUDA is not available", file=sys.stderr)
        return 1
    from zenker_audio_detection_tpu_torch.ops import _cuda
    from zenker_audio_detection_tpu_torch.ops import attention as A

    parser = argparse.ArgumentParser()
    parser.add_argument("--variants", nargs="+", default=list(VARIANTS),
                        choices=list(VARIANTS))
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args()
    _cuda.build_all()
    with ThreadPoolExecutor(max_workers=len(args.variants)) as pool:
        libs = dict(zip(args.variants, pool.map(build, args.variants)))

    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (B, S, NH * D), dtype=np.float32)).to("cuda", torch.bfloat16)
        for _ in range(4))
    o, lse = A.mha_packed_lse(q, k, v, num_heads=NH)
    dq_w, delta = A.mha_packed_bwd_dq(q, k, v, o, lse, g, num_heads=NH)
    dk_w, dv_w = A.mha_packed_bwd_dkdv(q, k, v, g, lse, delta, num_heads=NH)
    sms = A.sm_count(q.device)
    stream = torch.cuda.current_stream().cuda_stream

    def calls(name):
        lib = libs[name]
        dq, dl = torch.empty_like(q), torch.empty_like(delta)
        dk, dv = torch.empty_like(q), torch.empty_like(q)
        gq, tq, mq = geometry(name, "dq", sms)
        gk, tk, mk = geometry(name, "dkdv", sms)

        def run_dq():
            err = lib.mha_packed_bwd_dq_bf16(
                *(x.data_ptr() for x in (q, k, v, o, lse, g, dq, dl)),
                B, S, NH, D, gq, 1, 1, tq, mq, stream)
            assert err == 0, f"{name} bwd_dq: cudaError_t {err}"

        def run_dkdv():
            err = lib.mha_packed_bwd_dkdv_bf16(
                *(x.data_ptr() for x in (q, k, v, g, lse, delta, dk, dv)),
                B, S, NH, D, gk, 1, 1, tk, mk, stream)
            assert err == 0, f"{name} bwd_dkdv: cudaError_t {err}"

        return run_dq, run_dkdv, (dq, dl, dk, dv)

    timed = {}
    for name in args.variants:
        run_dq, run_dkdv, outs = calls(name)
        run_dq()
        run_dkdv()
        torch.cuda.synchronize()
        diffs = [float((a.float() - w.float()).abs().max())
                 for a, w in zip(outs, (dq_w, delta, dk_w, dv_w))]
        probe = VARIANTS[name][2]
        print(f"[bwd] {name}: max abs diff dq {diffs[0]:.3g}, delta "
              f"{diffs[1]:.3g}, dk {diffs[2]:.3g}, dv {diffs[3]:.3g} "
              f"against the package's kernels"
              + (" (a probe: not held)" if probe else ""), flush=True)
        if not probe and not max(diffs) <= 2e-2:
            print(f"[bwd] {name} disagrees: not timed", flush=True)
            continue
        timed[name] = (run_dq, run_dkdv)
    timed["package"] = (
        lambda: A.mha_packed_bwd_dq(q, k, v, o, lse, g, num_heads=NH),
        lambda: A.mha_packed_bwd_dkdv(q, k, v, g, lse, delta, num_heads=NH))

    def device_ms(fn) -> float:
        for _ in range(3):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    times = {name: {"dq": [], "dkdv": []} for name in timed}
    for _ in range(2):
        for name, (run_dq, run_dkdv) in timed.items():
            times[name]["dq"].append(round(device_ms(run_dq), 4))
            times[name]["dkdv"].append(round(device_ms(run_dkdv), 4))
    for name, t in times.items():
        print(f"[bwd] {name}: bwd_dq {t['dq']} ms, bwd_dkdv {t['dkdv']} ms",
              flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps({"shape": [B, S, NH * D], "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
