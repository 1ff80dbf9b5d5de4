#!/usr/bin/env python3
"""Times variants of csrc/attention_ws.cu, the warp-specialised walk of the
bf16 mha_packed and mha_packed_lse, on one NVIDIA GPU.

    python3 tools/packed_ws.py

Builds copies of the source with other tile shapes (its kKeys, kConsumers
and kStages constexprs: keys per K/V tile, consumer warpgroups, ring
stages), with the softmax in the folded form (maxima of the raw scores,
p = exp2(s * scale - m) by one FFMA, each tile's sum added at once) and
with the exponent as exp2f instead of ex2.approx.ftz, into
build/packed_ws/ (one nvcc each, in parallel; the package's kernels too, if
not built), and prints their registers and spills. Holds each variant's
mha_packed and mha_packed_lse to mha_packed_reference and
mha_packed_lse_reference (output 2e-2, lse 1e-4; the lse form's output
equal to the plain form's bit for bit) at the persistent walk's cases,
poisoned tails included; a variant that fails is named and not timed. Then
times both forms of each beside the package's (the source as it is, through
its wrapper), mha_batched_heads on the same memory (the pipelined walk of
csrc/attention_pipelined.cu) and scaled_dot_product_attention, at
(128, 1214, 768) and (16, 1214, 768) bf16 with 12 heads and at batch 1, two
rounds in turn (CUDA events, median of 20 launches after 3 warm-ups). Ends
with the card's name and power limit and one JSON line of the times. The
source is not changed. tools/train_route_noise.py runs the training route
on a variant through `use_variant`.
"""

from __future__ import annotations

import ctypes
import functools
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT_DIR = ROOT / "build" / "packed_ws"
# (B, S, NH, D): the main path's and the training step's widths, fewer work
# items than SMs, a count no multiple of the grid, one and three heads,
# 28 heads, head width 32
CASES = ((4, 1214, 12, 64), (4, 146, 12, 64), (1, 1214, 12, 64),
         (3, 1214, 12, 64), (2, 300, 1, 64), (2, 300, 3, 64),
         (1, 300, 28, 64), (2, 300, 4, 32), (2, 64, 4, 32))
TIMED = ((128, 1214, 12, 64), (16, 1214, 12, 64), (1, 1214, 12, 64))
# name -> (keys per K/V tile, consumer warpgroups, ring stages, the folded
# softmax, exp2f for the exponent); "source" is the source as it is
VARIANTS = {"source": (None, None, None, False, False),
            "k128_c2_s2_folded": (128, 2, 2, True, False),
            "k64_c3_s4_folded": (64, 3, 4, True, False),
            "k128_c2_s2": (128, 2, 2, False, False),
            "source_exp2f": (None, None, None, False, True)}
ATTN_TOL, LSE_TOL = 2e-2, 1e-4
EX2 = "  asm(\"ex2.approx.ftz.f32 %0, %1;\" : \"=f\"(y) : \"f\"(x));"
# the softmax of Rows, from its comment to the next member's
SOFTMAX = re.compile(r"  // The online softmax of the scores.*?(?=  // once the PV)",
                     re.DOTALL)
FOLDED = """  // The online softmax of the scores of keys k0.. in place, folded: the
  // maxima of the raw scores, then s becomes exp2(s * scale - m) by one
  // FFMA under the new maxima and l takes the tile's sums at once.
  __device__ __forceinline__ void softmax(int k0, int S, int t,
                                          float scale_log2) {
    const bool whole = k0 + kKeys <= S;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (!whole && k0 + n * 8 + 2 * t + e >= S) {
          s[4 * n + e] = -INFINITY;
          s[4 * n + 2 + e] = -INFINITY;
        }
        mx0 = fmaxf(mx0, s[4 * n + e]);
        mx1 = fmaxf(mx1, s[4 * n + 2 + e]);
      }
    }
    mx0 = fmaxf(m0, quad_max(mx0) * scale_log2);
    mx1 = fmaxf(m1, quad_max(mx1) * scale_log2);
    c0 = ex2(m0 - mx0);
    c1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * n + e] = ex2(fmaf(s[4 * n + e], scale_log2, -m0));
        s[4 * n + 2 + e] = ex2(fmaf(s[4 * n + 2 + e], scale_log2, -m1));
        sum0 += s[4 * n + e];
        sum1 += s[4 * n + 2 + e];
      }
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
  }
"""


def source(name: str) -> str:
    """The text of variant `name` of csrc/attention_ws.cu."""
    from zenker_audio_detection_tpu_torch.ops import _cuda

    keys, consumers, stages, folded, exp2 = VARIANTS[name]
    src = (_cuda.CSRC / "attention_ws.cu").read_text()
    if EX2 not in src or not SOFTMAX.search(src):
        raise SystemExit("the source no longer has the text this probe "
                         "edits; update the probe")
    for const, value in (("kKeys", keys), ("kConsumers", consumers),
                         ("kStages", stages)):
        if value is not None:
            src, n = re.subn(rf"^constexpr int {const} = \d+;",
                             f"constexpr int {const} = {value};", src,
                             flags=re.MULTILINE)
            if n != 1:
                raise SystemExit(f"no {const} constexpr in the source")
    if folded:
        src = SOFTMAX.sub(lambda _: FOLDED, src)
    if exp2:
        src = src.replace(EX2, "  y = exp2f(x);")
    return src


def build(name: str) -> ctypes.CDLL:
    """Compiles variant `name` into build/packed_ws/ and loads it, with the
    argument types of its two launch entry points."""
    from zenker_audio_detection_tpu_torch.ops import _cuda

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
    cu.write_text(source(name))
    proc = subprocess.run(
        [_cuda._nvcc(), *_cuda.NVCC_FLAGS, f"-I{_cuda.CSRC}", "-o", str(lib),
         str(cu)], capture_output=True, text=True)
    report = proc.stdout + proc.stderr
    for line in report.splitlines():
        if any(w in line for w in ("Used", "spill", "warning", "error")):
            print(f"[ws] {name}: {line.strip()}", flush=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{report}")
    cdll = ctypes.CDLL(str(lib))
    for fn_name, n_ptr in (("mha_packed_bf16", 4), ("mha_packed_lse_bf16", 5)):
        fn = getattr(cdll, fn_name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return cdll


def use_variant(name: str) -> None:
    """Routes the package's bf16 mha_packed and mha_packed_lse through
    variant `name`: its library and its launch geometry."""
    from zenker_audio_detection_tpu_torch.ops import _cuda
    from zenker_audio_detection_tpu_torch.ops import attention as A

    lib, tile = build(name), A.parse_ws_tile(source(name))
    load = _cuda.load
    _cuda.load = lambda src: lib if src == "attention_ws" else load(src)
    A.ws_tile = lambda: tile


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    from zenker_audio_detection_tpu_torch.ops import _cuda
    from zenker_audio_detection_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        print("packed_ws: CUDA is not available", file=sys.stderr)
        return 1
    _cuda.build_all()

    def try_build(name):
        try:
            return build(name)
        except RuntimeError as exc:  # a variant that does not build is left out
            print(f"[ws] {name} left out: {exc}", flush=True)
            return None

    with ThreadPoolExecutor(max_workers=len(VARIANTS)) as pool:
        libs = {n: lib for n, lib in zip(VARIANTS, pool.map(try_build,
                                                            VARIANTS)) if lib}
    sms = A.sm_count(torch.device("cuda", 0))
    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(B, S, H):
        return [torch.randn(B, S, H, device="cuda", generator=gen)
                .to(torch.bfloat16) for _ in range(3)]

    tiles = {name: A.parse_ws_tile(source(name)) for name in libs}

    def ws(name, q, k, v, nh, with_lse=False):
        B, S, H = q.shape
        geo = A.launch_geometry("mha_packed", B, S, nh, H // nh, 2, sms=sms,
                                tile=tiles[name])
        o = torch.empty_like(q)
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr()]
        fn = libs[name].mha_packed_bf16
        if with_lse:
            lse = torch.empty(B, nh, S, dtype=torch.float32, device="cuda")
            ptrs.append(lse.data_ptr())
            fn = libs[name].mha_packed_lse_bf16
        err = fn(*ptrs, B, S, nh, H // nh, *geo.grid, geo.threads, geo.smem,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed: cudaError_t {err}")
        return (o, lse) if with_lse else o

    wrong = set()

    def check(what, x, nh):
        ref, ref_lse = A.mha_packed_lse_reference(*(t.clone() for t in x), nh)
        worst = 0.0
        for name in libs:
            o = ws(name, *x, nh)
            o2, lse = ws(name, *x, nh, with_lse=True)
            torch.cuda.synchronize()
            err = (o.float() - ref.float()).abs().max().item()
            lerr = (lse - ref_lse).abs().max().item()
            same = torch.equal(o, o2)
            print(f"[ws] {name} {what}: max abs err {err:.3g} (tolerance "
                  f"{ATTN_TOL}), lse {lerr:.3g} ({LSE_TOL}), lse form's "
                  f"output bitwise: {same}", flush=True)
            if not (err <= ATTN_TOL and lerr <= LSE_TOL and same):
                wrong.add(name)
            worst = max(worst, err)
        return worst

    worst = 0.0
    for B, S, NH, D in CASES:
        worst = max(worst, check(f"{(B, S, NH, D)}", qkv(B, S, NH * D), NH))
    # poisoned tails: keys and values past S hold 1e4, and every buffer
    # past the view holds it too
    for H, nh in ((128, 2), (128, 4), (192, 3)):
        bufs = qkv(1, 128, H)
        for b in bufs:
            b[:, 65:] = 1e4
        worst = max(worst, check(f"poisoned tail (1, 65, {H}) nh={nh}",
                                 [b[:, :65] for b in bufs], nh))
    for name in sorted(wrong):  # a variant that is not right is not timed
        print(f"[ws] {name} disagrees with the plain versions: not timed")
        del libs[name]

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

    results = {}
    for rnd in range(2):
        for B, S, NH, D in TIMED:
            x = qkv(B, S, NH * D)
            heads = [t.view(B, S, NH, D).transpose(1, 2) for t in x]
            split = [t.view(B, S, NH, D) for t in x]
            fns = {"package": lambda: A.mha_packed(*x, num_heads=NH),
                   "package_lse": lambda: A.mha_packed_lse(*x, num_heads=NH),
                   "pipelined": lambda: A.mha_batched_heads(*split),
                   "sdpa": lambda: torch.nn.functional
                   .scaled_dot_product_attention(*heads)}
            for name in libs:
                fns[name] = functools.partial(ws, name, *x, NH)
                fns[f"{name}_lse"] = functools.partial(ws, name, *x, NH,
                                                       with_lse=True)
            order = list(fns) if rnd == 0 else list(reversed(fns))
            for name in order:
                ms = median_ms(fns[name])
                results.setdefault(f"{(B, S, NH, D)}", {}).setdefault(
                    name, []).append(ms)
                print(f"[ws] round {rnd} {(B, S, NH, D)} {name}: {ms:.4f} ms",
                      flush=True)
            del x, heads, split
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"max_abs_err": worst, "wrong": sorted(wrong),
                      "ms": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
