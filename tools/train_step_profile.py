#!/usr/bin/env python3
"""Times and traces the full-width training step on one NVIDIA GPU.

    python3 tools/train_step_profile.py [--steps 5] [--top 15]

The step of chip_smoke.py's training phase: ASTConfig() from numpy seed 7,
a batch of 16 seeded features and balanced labels, bf16, remat "full", the
"kernel" attention (mha_packed_trainable), stage1_loss(2.0, 0.07) and
make_optimizer(1e-5, 5 steps, no warmup, weight decay 0.013, beta2 0.97).
After three warm-up steps it times `--steps` steps on the host clock, each
ending in a host read of the loss (as chip_smoke.py does), then traces two
more with torch.profiler and prints the device time of the `--top` kernels,
all kernels' device time per step, the busy share of the traced wall time
and the launches per step of each attention kernel. Prints the card's name
and power limit first and one JSON line last. Run from a checkout's root;
it imports the package found there.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path.cwd()))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_step_profile: CUDA is not available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from zenker_audio_detection_tpu_torch.models import ast as ast_mod
    from zenker_audio_detection_tpu_torch.ops import attention as A
    from zenker_audio_detection_tpu_torch.train import losses, optim, steps

    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--top", type=int, default=15)
    args = parser.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    cfg = ast_mod.ASTConfig()
    rng = np.random.default_rng(8)
    feats = torch.from_numpy(rng.standard_normal(
        (16, cfg.max_length, cfg.num_mel_bins)).astype(np.float32)).cuda()
    labels = torch.from_numpy(rng.permutation(np.arange(16) % 2)).cuda()
    params = optim.tree_map(lambda t: t.cuda(), ast_mod.init_params(
        np.random.default_rng(7), cfg))
    tx = optim.make_optimizer(learning_rate=1e-5, total_steps=5,
                              warmup_ratio=0.0, weight_decay=0.013,
                              beta2=0.97)
    state = tx.init(params)

    def loss_fn(p, f, y):
        logits = ast_mod.forward(p, f, cfg, dtype=torch.bfloat16, remat=True,
                                 attention_impl="kernel")
        return losses.stage1_loss(logits, y, 2.0, 0.07), logits

    def step(p, s):
        (lv, _), g = steps.value_and_grad(loss_fn, p, feats, labels)
        u, s = tx.update(g, s, p)
        return optim.apply_updates(p, u), s, float(lv)

    for _ in range(3):
        params, state, _ = step(params, state)
    times = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, _ = step(params, state)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)

    kinds = ("mha_packed", "mha_packed_lse", "mha_packed_bwd_dq",
             "mha_packed_bwd_dkdv")
    before = {k: getattr(A, k).launches for k in kinds}
    traced = 2
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(traced):
            params, state, _ = step(params, state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: (getattr(A, k).launches - before[k]) // traced
                for k in kinds}
    # kernels only: device events whose name is not an operator's
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    if not kernels:
        kernels = [e for e in prof.key_averages()
                   if e.self_device_time_total > 0
                   and not e.key.startswith(("aten::", "_Mha"))]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[step] host ms per step over {args.steps} steps: "
          f"{[round(t, 2) for t in times]} (median {np.median(times):.2f})")
    print(f"[step] traced {traced} steps: {wall_ms:.2f} ms wall, device "
          f"busy {device_ms:.2f} ms ({100 * device_ms / wall_ms:.1f} %), "
          f"{device_ms / traced:.2f} ms of kernels per step")
    print(f"[step] attention launches per step: {launches}")
    for e in kernels[:args.top]:
        print(f"[step] {e.self_device_time_total / 1e3 / traced:9.3f} ms/step "
              f"{e.count // traced:5d}/step  {e.key[:100]}")
    print(json.dumps({
        "host_ms": times, "median_host_ms": float(np.median(times)),
        "device_ms_per_step": device_ms / traced,
        "busy_share": device_ms / wall_ms, "launches": launches,
        "top": {e.key[:100]: e.self_device_time_total / 1e3 / traced
                for e in kernels[:args.top]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
