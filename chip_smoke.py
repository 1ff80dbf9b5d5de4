#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, long-recording two-stage inference, at the
full AST width (ASTConfig(): 12 layers, H=768, 1214 tokens) with random
weights made from fixed seeds, and holds every CUDA kernel of that path
against its plain PyTorch version on the card. Phases, each of which fails
the run loudly:

  1. device: CUDA must be present; prints nvidia-smi's name and power limit;
  2. build: compiles every kernel source with nvcc (in parallel);
  3. kernel vs plain: mha_packed against mha_packed_reference at the main
     path's shapes and at head width 32, then times kernel, plain version
     and PyTorch's scaled_dot_product_attention (the yardstick; the port
     never calls it) at (128, 1214, 768) bf16;
  3b. attention entry points: mha, mha_batched_heads, mha_qblock and
     mha_fused driven at the AST's attention width (128, 1214, 12, 64) and
     (128, 146, 12, 64) bf16 with the launch counters zeroed just before
     and read just after; each held against reference_mha there, at the
     JAX tests' shapes and block_q values, at the AST shapes in bf16 and
     f32, and on a poisoned tail (keys past S must not be read); then
     timed like mha_packed;
  4. engine: TwoStageEngine at batch 128, bf16, attention_impl="kernel" on
     60 s of seeded int16 audio in "all" and "gated" modes, with the launch
     counter zeroed just before and read just after; the window
     probabilities are held against the same engine with
     attention_impl="torch", and a small f32 model against the CPU;
  5. CLI: cli.infer_long_audio on two WAVs and two exported full-size model
     directories.

The line before the last is {"kernels": [...]} with each kernel's numbers;
the last line is {"ok": true, "device": {...}}. Exits non-zero, and prints
no result, without CUDA. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core rate, f32
# rate outside the tensor cores, HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# mha_packed vs mha_packed_reference on the card. bf16: the kernel rounds
# the unnormalised exp(s - m) to bf16 where the plain version rounds the
# normalised p, and both round the O(1) outputs to bf16 (2^-8 relative), so
# they agree to a few bf16 ulps, not bitwise. f32: only the summation order
# differs (online softmax over 64-key tiles vs one pass).
ATTN_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# window probabilities of the bf16 engine, "kernel" vs "torch" attention:
# the attention rounding differences above pass through 12 bf16 layers
ENGINE_TOL = 2e-2
# small f32 model, kernel on the card vs plain version on the CPU (logits)
SMALL_F32_TOL = 1e-4
MAIN_SHAPE = (128, 1214, 768, 12)  # (B, S, H, NH) of the AST at batch 128
# the (B, S, NH, D) entry points: the AST's attention at batch 128, full
# length and short-sequence length (max_length 128)
ENTRY_SHAPES = ((128, 1214, 12, 64), (128, 146, 12, 64))
ENTRY_POINTS = {  # name -> the Pallas function it replaces
    "mha": "zenker_audio_detection_tpu/ops/attention.py:79",
    "mha_batched_heads": "zenker_audio_detection_tpu/ops/attention.py:137",
    "mha_qblock": "zenker_audio_detection_tpu/ops/attention.py:182",
    "mha_fused": "zenker_audio_detection_tpu/ops/attention.py:252",
}
# (S, block_q) of tests/test_pallas_attention.py:74-80
QBLOCK_CASES = ((64, 64), (300, 128), (100, 256), (1280, 96), (200, 96))
KERNEL_SOURCE = "zenker_audio_detection_tpu_torch/csrc/attention.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def zero_counts(A) -> None:
    for name in ("mha_packed", *ENTRY_POINTS):
        getattr(A, name).launches = 0


def bound(B: int, S: int, NH: int, D: int, itemsize: int) -> dict:
    """The least time the card needs for attention at (B, S, NH, D):
    4 B NH S^2 D operations at the peak rate of the dtype (the bf16 tensor
    cores; plain f32, since the kernels never use TF32) against q, k, v and
    the output moved once at the memory rate."""
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS
    flops = 4.0 * B * NH * S * S * D
    nbytes = 4.0 * B * S * NH * D * itemsize
    flops_ms = flops / peak * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return {"bound_ms": max(flops_ms, bytes_ms),
            "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
            "text": f"{flops / 1e9:.1f} GFLOP at {peak / 1e12:.0f} TFLOP/s "
                    f"= {flops_ms:.4f} ms; {nbytes / 1e6:.1f} MB at 3.35 "
                    f"TB/s = {bytes_ms:.4f} ms"}


def require_close(what: str, out, ref, dtype) -> float:
    err = (out.float() - ref.float()).abs().max().item()
    tol = ATTN_TOL[str(dtype).split(".")[-1]]
    log(f"[kernel] {what}: max abs err {err:.3g} (tolerance {tol})")
    if not (out.shape == ref.shape and math.isfinite(err) and err <= tol):
        raise AssertionError(f"{what} disagrees with its plain version: "
                             f"{err} > {tol}")
    return err


def median_ms(fn, warmup: int = 2, iters: int = 10) -> float:
    import torch

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


def phase_kernel_vs_plain(A) -> dict:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(0)

    def qkv(B, S, H, dtype):
        return [torch.randn(B, S, H, device="cuda", generator=gen).to(dtype)
                for _ in range(3)]

    cases = [(4, 1214, 768, 12, torch.bfloat16),
             (4, 1214, 768, 12, torch.float32),
             (4, 146, 768, 12, torch.bfloat16),
             (2, 300, 256, 4, torch.bfloat16),
             (2, 300, 128, 4, torch.bfloat16),  # head width 32
             (2, 300, 128, 4, torch.float32)]
    for B, S, H, nh, dtype in cases:
        q, k, v = qkv(B, S, H, dtype)
        out = A.mha_packed(q, k, v, num_heads=nh)
        torch.cuda.synchronize()
        ref = A.mha_packed_reference(q, k, v, nh)
        torch.cuda.synchronize()
        require_close(f"mha_packed {(B, S, H)} nh={nh} {dtype}", out, ref,
                      dtype)

    B, S, H, nh = MAIN_SHAPE
    D = H // nh
    q, k, v = qkv(B, S, H, torch.bfloat16)
    out = A.mha_packed(q, k, v, num_heads=nh)
    ref = A.mha_packed_reference(q, k, v, nh)
    torch.cuda.synchronize()
    err = require_close(f"mha_packed {(B, S, H)} bf16", out, ref,
                        torch.bfloat16)
    del out, ref

    ms = median_ms(lambda: A.mha_packed(q, k, v, num_heads=nh))
    plain_ms = median_ms(lambda: A.mha_packed_reference(q, k, v, nh),
                         warmup=1, iters=3)
    heads = [x.view(B, S, nh, D).transpose(1, 2) for x in (q, k, v)]
    library_ms = median_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(*heads))
    b = bound(B, S, nh, D, q.element_size())
    log(f"[kernel] timing at {(B, S, H)} bf16: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} "
        f"ms; bound {b['bound_ms']:.4f} ms ({b['text']})")
    # the same H cut into 24 heads of 32: the head width of the JAX tests
    ms32 = median_ms(lambda: A.mha_packed(q, k, v, num_heads=2 * nh))
    b32 = bound(B, S, 2 * nh, D // 2, q.element_size())
    log(f"[kernel] timing at {(B, S, H)} bf16 with {2 * nh} heads of "
        f"{D // 2}: kernel {ms32:.4f} ms; bound {b32['bound_ms']:.4f} ms")
    x32 = qkv(B, S, H, torch.float32)
    ms_f32 = median_ms(lambda: A.mha_packed(*x32, num_heads=nh))
    b_f32 = bound(B, S, nh, D, 4)
    log(f"[kernel] timing at {(B, S, H)} f32: kernel {ms_f32:.4f} ms; bound "
        f"{b_f32['bound_ms']:.4f} ms ({b_f32['text']})")
    del x32
    return {"name": "mha_packed", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": "zenker_audio_detection_tpu/ops/attention.py:320",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": library_ms}


def phase_entry_points(A, torch) -> list:
    """The four (B, S, NH, D) entry points: their own path at the AST's
    attention width, then every check against the plain version, then
    their times."""
    gen = torch.Generator(device="cuda").manual_seed(1)

    def qkv(shape, dtype):
        return [torch.randn(*shape, device="cuda", generator=gen).to(dtype)
                for _ in range(3)]

    fns = {name: getattr(A, name) for name in ENTRY_POINTS}
    full, short = (qkv(shape, torch.bfloat16) for shape in ENTRY_SHAPES)

    # ---- the slice's path: counts zeroed just before, read just after ----
    zero_counts(A)
    torch.cuda.synchronize()
    outs = {name: (fn(*full), fn(*short)) for name, fn in fns.items()}
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in fns.items()}
    # -----------------------------------------------------------------------
    log(f"[entry] launches on the entry points' path: {launches} "
        f"(mha_packed {A.mha_packed.launches})")
    if any(n != len(ENTRY_SHAPES) for n in launches.values()) \
            or A.mha_packed.launches:
        raise AssertionError(f"launch counts {launches} on the entry "
                             f"points' path")
    errs = {}
    for i, x in enumerate((full, short)):
        ref = A.reference_mha(*x)
        for name in fns:
            err = require_close(f"{name} {tuple(x[0].shape)} bf16 (path)",
                                outs[name][i], ref, torch.bfloat16)
            errs[name] = max(errs.get(name, 0.0), err)
        del ref
    del outs, short

    # ---- against the plain version; these launches do not count ----
    cases = ([((2, S, 4, 32), torch.float32, None) for S in (64, 100, 128, 300)]
             + [((2, S, 4, 32), torch.float32, bq) for S, bq in QBLOCK_CASES]
             + [((1, 70, 2, 64), torch.bfloat16, None)]
             + [((4, S, 12, 64), dtype, None) for S in (1214, 146)
                for dtype in (torch.bfloat16, torch.float32)])
    for shape, dtype, bq in cases:
        x = qkv(shape, dtype)
        ref = A.reference_mha(*x)
        for name, fn in fns.items():
            if bq is not None and name not in ("mha_qblock", "mha_fused"):
                continue
            kw = {} if bq is None else {"block_q": bq}
            out = fn(*x, **kw)
            torch.cuda.synchronize()
            require_close(f"{name} {shape} {dtype} block_q={bq}", out, ref,
                          dtype)

    # the poisoned tail: keys and values past S hold 1e4; a kernel that
    # reads or fails to mask them moves every softmax row
    bufs = qkv((1, 128, 2, 32), torch.float32)
    for b in bufs:
        b[:, 65:] = 1e4
    views = [b[:, :65] for b in bufs]  # contiguous at B = 1
    ref = A.reference_mha(*(v.clone() for v in views))
    for name, fn in fns.items():
        out = fn(*views)
        torch.cuda.synchronize()
        require_close(f"{name} poisoned tail (1, 65, 2, 32) f32", out, ref,
                      torch.float32)

    # ---- times at the AST width, bf16 ----
    B, S, NH, D = ENTRY_SHAPES[0]
    q, k, v = full
    plain_ms = median_ms(lambda: A.reference_mha(q, k, v), warmup=1, iters=3)
    heads = [x.transpose(1, 2) for x in full]  # (B, NH, S, D) views
    library_ms = median_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(*heads))
    b = bound(B, S, NH, D, q.element_size())
    records = []
    for name, fn in fns.items():
        ms = median_ms(lambda: fn(q, k, v))
        log(f"[entry] timing {name} at {(B, S, NH, D)} bf16: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"scaled_dot_product_attention {library_ms:.4f} ms; bound "
            f"{b['bound_ms']:.4f} ms ({b['text']})")
        records.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": ENTRY_POINTS[name], "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": library_ms})
    return records


def seeded_audio(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000.0
    x = 0.1 * rng.standard_normal(t.shape) * (1.0 + np.sin(2 * np.pi * 0.3 * t))
    return np.clip(x * 32768.0, -32768, 32767).astype(np.int16)


def full_size_specs(C, ast_mod, stage1_bias_shift: float = 0.0):
    from zenker_audio_detection_tpu_torch.ops import fbank as F

    cfg = ast_mod.ASTConfig()
    params1 = ast_mod.init_params(np.random.default_rng(1), cfg)
    params2 = ast_mod.init_params(np.random.default_rng(2), cfg)
    params1["head"]["dense"]["bias"][1] += stage1_bias_shift
    norm = (F.DATASET_FALLBACK_MEAN, F.DATASET_FALLBACK_STD)
    s1 = C.StageSpec(params1, cfg, *norm, ("Idle", "Swallow"))
    s2 = C.StageSpec(params2, cfg, *norm, ("Healthy", "Zenker"))
    return s1, s2


def check_probs(p: np.ndarray, W: int, what: str) -> None:
    if p.shape != (W, 2) or not np.isfinite(p).all():
        raise AssertionError(f"{what}: bad probabilities {p.shape}")
    rows = p[np.abs(p).sum(axis=1) > 0]
    if not np.allclose(rows.sum(axis=1), 1.0, atol=1e-5):
        raise AssertionError(f"{what}: rows do not sum to 1")


def phase_engine(A, C, ast_mod, torch, name: str) -> int:
    batch = 128
    audio = seeded_audio(60.0, seed=3)
    W = len(C.window_starts(len(audio), 1.0, 0.5))
    chunks = -(-W // batch)
    kw = dict(batch_size=batch, dtype=torch.bfloat16)
    s1, s2 = full_size_specs(C, ast_mod)
    t0 = time.perf_counter()
    engine_all = C.TwoStageEngine(s1, s2, C.CascadeConfig(
        stage2_mode="all", attention_impl="kernel", **kw), device="cuda")
    log(f"[engine] full-size stages on the card in "
        f"{time.perf_counter() - t0:.1f} s; {W} windows of 60 s audio")
    engine_all.window_probs(audio)  # warm-up: cuBLAS/cuDNN initialisation

    # The stage-1 gate on random weights: shift the class-1 head bias and
    # pick the threshold so that about a third of the windows pass (the
    # study's rate, bench.py:calibrated_gated_engine).
    p1_probe, _ = engine_all.window_probs(audio)
    p = np.clip(p1_probe[:, 1], 1e-9, 1 - 1e-9)
    d = np.log((1 - p) / p)
    delta = float(np.quantile(d, 0.995))
    threshold = max(0.5, float(np.quantile(1.0 / (1.0 + np.exp(d - delta)),
                                           1.0 - 1.0 / 3.0)))
    g1, g2 = full_size_specs(C, ast_mod, stage1_bias_shift=delta)
    engine_gated = C.TwoStageEngine(g1, g2, C.CascadeConfig(
        stage2_mode="gated", attention_impl="kernel",
        stage1_threshold=threshold, **kw), device="cuda")
    engine_gated.window_probs(audio)  # warm-up

    # ---- the main path: counts zeroed just before, read just after ----
    zero_counts(A)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p1_all, p2_all = engine_all.window_probs(audio)
    all_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p1_g, p2_g = engine_gated.window_probs(audio)
    gated_s = time.perf_counter() - t0
    launches = A.mha_packed.launches
    others = {name: getattr(A, name).launches for name in ENTRY_POINTS}
    # ------------------------------------------------------------------

    n_gated = len(engine_gated._gate_indices(p1_g))
    layers = ast_mod.ASTConfig().num_hidden_layers
    expected = layers * (2 * chunks + chunks + -(-n_gated // batch))
    log(f"[engine] mha_packed launches on the main path: {launches} "
        f"(expected {expected} = {layers} layers x chunks run; {n_gated} of "
        f"{W} windows gated); the other entry points: {others}")
    if launches != expected or any(others.values()):
        raise AssertionError(f"launch count {launches} != {expected} or "
                             f"{others} not all 0")
    for p_, what in ((p1_all, "all/stage1"), (p2_all, "all/stage2"),
                     (p1_g, "gated/stage1"), (p2_g, "gated/stage2")):
        check_probs(p_, W, what)
    if not 0 < n_gated < W:
        raise AssertionError(f"the calibrated gate passed {n_gated} of {W}")
    log(f"[engine] {name}: all mode {W / all_s:.2f} windows/s "
        f"({all_s:.3f} s), gated mode {W / gated_s:.2f} windows/s "
        f"({gated_s:.3f} s, {n_gated}/{W} gated), batch {batch}, bf16")

    engine_torch = C.TwoStageEngine(s1, s2, C.CascadeConfig(
        stage2_mode="all", attention_impl="torch", **kw), device="cuda")
    before = A.mha_packed.launches
    q1, q2 = engine_torch.window_probs(audio)
    if A.mha_packed.launches != before:
        raise AssertionError("attention_impl='torch' launched the kernel")
    err = max(np.abs(q1 - p1_all).max(), np.abs(q2 - p2_all).max())
    log(f"[engine] window probabilities, kernel vs torch attention: max abs "
        f"err {err:.3g} (tolerance {ENGINE_TOL})")
    if not err <= ENGINE_TOL:
        raise AssertionError(f"kernel and torch engines disagree: {err}")
    return launches


def phase_small_f32(A, ast_mod, torch) -> None:
    """A small f32 model with the AST's head width: the kernel path on the
    card against the plain path on the CPU."""
    cfg = ast_mod.ASTConfig(hidden_size=128, num_hidden_layers=2,
                            num_attention_heads=2, intermediate_size=256,
                            max_length=256)
    params = ast_mod.init_params(np.random.default_rng(5), cfg)
    gen = np.random.default_rng(6)
    for key in ("pos_embed", "cls_token", "dist_token"):
        params[key] = torch.from_numpy(
            gen.standard_normal(params[key].shape).astype(np.float32))
    x = torch.from_numpy(gen.standard_normal(
        (3, cfg.max_length, cfg.num_mel_bins)).astype(np.float32))
    want = ast_mod.forward(params, x, cfg, attention_impl="kernel")
    dev = ast_mod.cast_params(params, torch.float32, "cuda")
    got = ast_mod.forward(dev, x.cuda(), cfg, attention_impl="kernel").cpu()
    err = (got - want).abs().max().item()
    log(f"[engine] small f32 model, card vs CPU: max abs logit err "
        f"{err:.3g} (tolerance {SMALL_F32_TOL})")
    if not err <= SMALL_F32_TOL:
        raise AssertionError(f"f32 forward on the card disagrees: {err}")


def phase_cli(A, C, ast_mod, torch) -> None:
    from zenker_audio_detection_tpu_torch.audio import io as aio
    from zenker_audio_detection_tpu_torch.cli import infer_long_audio
    from zenker_audio_detection_tpu_torch.models import convert
    from zenker_audio_detection_tpu_torch.train import loop as train_loop

    s1, s2 = full_size_specs(C, ast_mod)
    with tempfile.TemporaryDirectory() as tmp:
        roots = []
        for k, spec in enumerate((s1, s2)):
            root = os.path.join(tmp, f"stage{k + 1}")
            convert.save_hf_model_dir(spec.params, spec.config, root)
            train_loop.save_feature_extractor_config(root, spec.mean, spec.std)
            roots.append(root)
        patient = os.path.join(tmp, "data", "Zenker", "P001")
        os.makedirs(patient)
        lengths = (20.0, 15.5)
        for k, seconds in enumerate(lengths):
            aio.write_wav(os.path.join(patient, f"rec_{k}.wav"),
                          seeded_audio(seconds, seed=10 + k) / 32768.0, 16000)
        out_json = os.path.join(tmp, "P001_2stage.json")
        A.mha_packed.launches = 0
        out = infer_long_audio.main([
            "--patient-id", "P001", "--long-audio-root",
            os.path.join(tmp, "data"), "--stage1-model-root", roots[0],
            "--stage2-model-root", roots[1], "--disable-cache",
            "--stage2-mode", "all", "--output-json", out_json,
            "--show-first-n", "0"])
        launches = A.mha_packed.launches
        with open(out_json) as f:
            saved = json.load(f)
    windows = sum(len(C.window_starts(int(16000 * s), 1.0, 0.5))
                  for s in lengths)
    agg = saved["aggregate"]
    if set(saved) != {"config", "per_file", "aggregate"} or saved != json.loads(
            json.dumps(out)):
        raise AssertionError("CLI JSON has the wrong keys or differs from "
                             "the returned output")
    if (agg["total_windows"] != windows
            or agg["total_idle_windows"] + agg["total_swallow_windows"]
            != windows or sorted(saved["per_file"]) != ["file_0", "file_1"]):
        raise AssertionError(f"CLI window counts are wrong: {agg}")
    if launches != 2 * 2 * 12:  # 2 files x 2 stages x 1 chunk x 12 layers
        raise AssertionError(f"CLI launched mha_packed {launches} times")
    log(f"[cli] patient JSON: {agg['total_windows']} windows, "
        f"{agg['total_swallow_windows']} swallow; mha_packed launches "
        f"{launches}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from zenker_audio_detection_tpu_torch.infer import cascade as C
    from zenker_audio_detection_tpu_torch.models import ast as ast_mod
    from zenker_audio_detection_tpu_torch.ops import _cuda
    from zenker_audio_detection_tpu_torch.ops import attention as A

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    built = _cuda.build_all()
    log(f"[build] {built} (nvcc seconds per source; 0 = already built), "
        f"{time.perf_counter() - t0:.1f} s in all")
    for source in built:
        report = _cuda.library_path(source).with_suffix(".so.log").read_text()
        for line in report.splitlines():
            if "Compiling entry function" in line or "Used" in line:
                log(f"[build] {source}: {line.strip()}")

    record = phase_kernel_vs_plain(A)
    records = [record, *phase_entry_points(A, torch)]
    record["launches"] = phase_engine(A, C, ast_mod, torch, name)
    phase_small_f32(A, ast_mod, torch)
    phase_cli(A, C, ast_mod, torch)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
