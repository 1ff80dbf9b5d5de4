#!/usr/bin/env python3
"""Times variants of csrc/attention_pipelined.cu's bf16 body on one NVIDIA GPU.

    python3 tools/pipelined_variants.py

Builds copies of the source with the K/V ring 2, 3 (the source's) and 4
stages deep, each with the softmax as written and with the scale folded into
the exponent's FFMA (max over raw scores, p = exp2(s * scale - m)), into
build/pipelined_variants/, and times mha_batched_heads and mha_fused of each
at (128, 1214, 12, 64) bf16, two rounds in turn (CUDA events, median of 20
launches after 3 warm-ups), each checked against reference_mha. Prints
every instance's registers, the card's name and power limit, and one line
per (round, variant, kernel). The source itself is not changed.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SHAPE = (128, 1214, 12, 64)
KINDS = ("mha_batched_heads", "mha_fused")
# the softmax of item(): scale, mask and max, then p; and its folded form
SCALED_MAX = """    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = k0 + n * 8 + 2 * t + e < S;
        s[4 * n + e] = ok ? s[4 * n + e] * scale_log2 : -INFINITY;
        s[4 * n + 2 + e] = ok ? s[4 * n + 2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[4 * n + e]);
        mx1 = fmaxf(mx1, s[4 * n + 2 + e]);
      }
    }
    // key 0 is in the first tile, so the maxima are finite from here on
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);"""
RAW_MAX = """    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool ok = k0 + n * 8 + 2 * t + e < S;
        s[4 * n + e] = ok ? s[4 * n + e] : -INFINITY;
        s[4 * n + 2 + e] = ok ? s[4 * n + 2 + e] : -INFINITY;
        mx0 = fmaxf(mx0, s[4 * n + e]);
        mx1 = fmaxf(mx1, s[4 * n + 2 + e]);
      }
    }
    mx0 = fmaxf(m0, quad_max(mx0) * scale_log2);
    mx1 = fmaxf(m1, quad_max(mx1) * scale_log2);"""
SCALED_P = """      const float p0 = exp2f(s[4 * n] - m0), p1 = exp2f(s[4 * n + 1] - m0);
      const float p2 = exp2f(s[4 * n + 2] - m1), p3 = exp2f(s[4 * n + 3] - m1);"""
FFMA_P = """      const float p0 = exp2f(fmaf(s[4 * n], scale_log2, -m0));
      const float p1 = exp2f(fmaf(s[4 * n + 1], scale_log2, -m0));
      const float p2 = exp2f(fmaf(s[4 * n + 2], scale_log2, -m1));
      const float p3 = exp2f(fmaf(s[4 * n + 3], scale_log2, -m1));"""
STAGES = "constexpr int kStages = 3;"


def variants(src: str) -> dict:
    """name -> (ring stages, source text)."""
    for text in (SCALED_MAX, SCALED_P, STAGES):
        if text not in src:
            raise SystemExit("the source no longer has the text this probe "
                             "edits; update the probe")
    out = {}
    for stages in (2, 3, 4):
        for ffma in (False, True):
            text = src.replace(STAGES, f"constexpr int kStages = {stages};")
            if ffma:
                text = text.replace(SCALED_MAX, RAW_MAX).replace(SCALED_P,
                                                                 FFMA_P)
            out[f"stages{stages}{'_ffma' if ffma else ''}"] = (stages, text)
    return out


def main() -> int:
    import torch

    from zenker_audio_detection_tpu_torch.ops import _cuda
    from zenker_audio_detection_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        print("pipelined_variants: CUDA is not available", file=sys.stderr)
        return 1
    out_dir = ROOT / "build" / "pipelined_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_cuda.CSRC / "attention_pipelined.cu").read_text()
    table = variants(src)

    def build(name: str):
        cu = out_dir / f"{name}.cu"
        cu.write_text(table[name][1])
        proc = subprocess.run(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{_cuda.CSRC}", "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
        return [line.split(":", 1)[1].strip()
                for line in (proc.stdout + proc.stderr).splitlines()
                if "Used" in line]

    with ThreadPoolExecutor(max_workers=len(table)) as pool:
        regs = dict(zip(table, pool.map(build, table)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    for name, lines in regs.items():
        print(f"[variants] {name}: {lines}")

    B, S, NH, D = SHAPE
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = [torch.randn(*SHAPE, device="cuda", generator=gen)
         .to(torch.bfloat16) for _ in range(3)]
    ref = A.reference_mha(*x).float()
    stream = torch.cuda.current_stream().cuda_stream

    def runner(lib, kind: str, stages: int):
        fn = getattr(lib, f"{kind}_bf16")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        geo = A.launch_geometry(kind, B, S, NH, D, 2,
                                sms=torch.cuda.get_device_properties(0)
                                .multi_processor_count)
        heads = 2 if kind == "mha_fused" else 1
        smem = stages * 2 * heads * 64 * D * 2 + 1024
        out = torch.empty_like(x[0])

        def go():
            err = fn(*(t.data_ptr() for t in (*x, out)), B, S, NH, D,
                     *geo.grid, geo.threads, smem, stream)
            if err:
                raise RuntimeError(f"launch failed: cudaError_t {err}")
            return out
        return go

    def median_ms(fn, warmup=3, iters=20):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    libs = {name: ctypes.CDLL(str(out_dir / f"{name}.so")) for name in table}
    for rnd in range(2):
        for name, lib in libs.items():
            for kind in KINDS:
                go = runner(lib, kind, table[name][0])
                err = (go().float() - ref).abs().max().item()
                if not err <= 2e-2:
                    raise AssertionError(f"{name} {kind} disagrees: {err}")
                print(f"[variants] round {rnd} {name} {kind}: "
                      f"{median_ms(go):.4f} ms (max abs err {err:.3g})",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
