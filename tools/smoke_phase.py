#!/usr/bin/env python3
"""Runs phases of a checkout's chip_smoke.py alone, on one NVIDIA GPU.

    python3 tools/smoke_phase.py [--phases train_alone train]

Run from a checkout's root: it imports that checkout's chip_smoke.py and
package, builds the kernels, then runs the named phases in order, as
chip_smoke.py's main would but without the phases before them:
`train_alone` (mha_packed_trainable alone at (16, 1214, 768)) and `train`
(the full-width training step of both routes, which logs its ms per step).
After each phase it prints the caching allocator's counters (device
allocations and frees, allocation retries, reserved and allocated GB), so
two checkouts' phases can be compared alone and after each other in one
call. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))
PHASES = ("train_alone", "train")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("smoke_phase: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from zenker_audio_detection_tpu_torch.models import ast as ast_mod
    from zenker_audio_detection_tpu_torch.ops import _cuda
    from zenker_audio_detection_tpu_torch.ops import attention as A

    parser = argparse.ArgumentParser()
    parser.add_argument("--phases", nargs="+", choices=PHASES,
                        default=["train"])
    args = parser.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _cuda.build_all()
    for phase in args.phases:
        t0 = time.perf_counter()
        if phase == "train_alone":
            chip_smoke.phase_train_alone(A, torch)
        else:
            chip_smoke.phase_train(A, ast_mod, torch)
        stats = torch.cuda.memory_stats()
        print(f"[phase] {phase}: {time.perf_counter() - t0:.1f} s; allocator "
              f"{stats.get('num_device_alloc')} device allocations, "
              f"{stats.get('num_device_free')} frees, "
              f"{stats.get('num_alloc_retries')} retries, reserved "
              f"{torch.cuda.memory_reserved() / 1e9:.2f} GB, allocated "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
