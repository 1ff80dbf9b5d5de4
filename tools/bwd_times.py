#!/usr/bin/env python3
"""Times the backward kernels of `mha_packed_trainable` on one NVIDIA GPU.

    python3 tools/bwd_times.py [--iters 50] [--rounds 3]

Run from a checkout's root: it imports that checkout's package, so a parent
checkout unpacked under a gitignored directory can be timed in the same
call, in turns. At the training shape (B, S, H) = (16, 1214, 768) bf16, 12
heads, on seeded inputs, it times `mha_packed_bwd_dq`, `mha_packed_bwd_dkdv`,
both in turn (`mha_packed_bwd`), the lse forward and
scaled_dot_product_attention's backward: `--iters` calls queued between two
CUDA events, so the device time per call is read without the host's time
between calls (chip_smoke.py times one call between its events, which
includes the wrapper's host path), after a warm-up, `--rounds` times each.
Prints the card's name and power limit, then one JSON line per entry point
with its rounds' ms per call and their median, and the wrapper's host ms
per call (the loop's wall time over the calls, with the device queue kept
full).
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
B, S, NH, D = 16, 1214, 12, 64


def queued_ms(torch, fn, iters: int) -> tuple[float, float]:
    """(device ms per call, host ms per call) of `iters` queued calls."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    host = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bwd_times: CUDA is not available", file=sys.stderr)
        return 1
    from zenker_audio_detection_tpu_torch.ops import attention as A

    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--rounds", type=int, default=3)
    args = parser.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (B, S, NH * D), dtype=np.float32)).to("cuda", torch.bfloat16)
        for _ in range(4))
    o, lse = A.mha_packed_lse(q, k, v, num_heads=NH)
    _, delta = A.mha_packed_bwd_dq(q, k, v, o, lse, g, num_heads=NH)
    xs = [x.view(B, S, NH, D).transpose(1, 2).detach().requires_grad_()
          for x in (q, k, v)]
    o_s = torch.nn.functional.scaled_dot_product_attention(*xs)
    g_s = g.view(B, S, NH, D).transpose(1, 2)
    calls = {
        "mha_packed_bwd_dq": lambda: A.mha_packed_bwd_dq(
            q, k, v, o, lse, g, num_heads=NH),
        "mha_packed_bwd_dkdv": lambda: A.mha_packed_bwd_dkdv(
            q, k, v, g, lse, delta, num_heads=NH),
        "mha_packed_bwd": lambda: A.mha_packed_bwd(
            q, k, v, o, lse, g, num_heads=NH),
        "mha_packed_lse": lambda: A.mha_packed_lse(q, k, v, num_heads=NH),
        "sdpa_backward": lambda: torch.autograd.grad(
            o_s, xs, g_s, retain_graph=True),
    }
    for name, fn in calls.items():
        for _ in range(5):
            fn()
        rounds = [queued_ms(torch, fn, args.iters)
                  for _ in range(args.rounds)]
        print(json.dumps({
            "name": name, "shape": [B, S, NH * D], "dtype": "bfloat16",
            "ms": [round(r[0], 4) for r in rounds],
            "median_ms": round(float(np.median([r[0] for r in rounds])), 4),
            "host_ms": round(float(np.median([r[1] for r in rounds])), 4)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
