#!/usr/bin/env python3
"""Times mha and mha_pairs beside mha_packed and SDPA on one NVIDIA GPU.

    python3 tools/entry_times.py

At the AST's attention width, (B, S, NH, D) = (128, 1214, 12, 64), in bf16
and f32, and at B = 1 in bf16, on seeded inputs: mha on (B, S, NH, D)
tensors, mha_pairs and mha_packed on the packed (B, S, NH * D) view of the
same memory, and torch's scaled_dot_product_attention on the (B, NH, S, D)
view. Each time is the median of 10 CUDA-event runs after 2 warm-ups, as in
chip_smoke.py. Prints the card's name and power limit first and one JSON
line last. Run from a checkout's root; it imports the package found there,
so a parent checkout is timed with the same script in the same call.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path.cwd()))
SHAPE = (128, 1214, 12, 64)  # (B, S, NH, D)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("entry_times: CUDA is not available", file=sys.stderr)
        return 1
    from zenker_audio_detection_tpu_torch.ops import attention as A

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, S, NH, D = SHAPE
    found = {}
    for B, dtype in ((SHAPE[0], torch.bfloat16), (SHAPE[0], torch.float32),
                     (1, torch.bfloat16)):
        x = [torch.randn(B, S, NH, D, device="cuda", generator=gen).to(dtype)
             for _ in range(3)]
        packed = [t.view(B, S, NH * D) for t in x]
        heads = [t.transpose(1, 2) for t in x]
        row = {
            "mha": median_ms(lambda: A.mha(*x)),
            "mha_pairs": median_ms(lambda: A.mha_pairs(*packed,
                                                       num_heads=NH)),
            "mha_packed": median_ms(lambda: A.mha_packed(*packed,
                                                         num_heads=NH)),
            "sdpa": median_ms(lambda: torch.nn.functional
                              .scaled_dot_product_attention(*heads))}
        key = f"B={B} {str(dtype).split('.')[-1]}"
        found[key] = row
        print(f"[times] {key}: " + ", ".join(f"{k} {v:.4f} ms"
                                             for k, v in row.items()),
              flush=True)
        del x, packed, heads
    print(json.dumps(found))
    return 0


if __name__ == "__main__":
    sys.exit(main())
