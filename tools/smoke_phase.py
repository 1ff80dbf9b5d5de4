#!/usr/bin/env python3
"""Runs phases of a checkout's chip_smoke.py alone, on one NVIDIA GPU.

    python3 tools/smoke_phase.py [--phases relpos epilogue engine
                                   beats_engine
                                   train_alone train loop serving audio
                                   parallel workflow mesh]

Run from a checkout's root: it imports that checkout's chip_smoke.py and
package, builds the kernels, then runs the named phases in order, as
chip_smoke.py's main would but without the phases before them:
`relpos` (phase 3d: mha_packed_relpos against its plain version, timed
beside mha_packed), `epilogue` (phase 3e: the AST and BEATs trunks'
elementwise epilogues against their plain versions, timed beside them
and their bytes bound, both trunks fused and composed), `engine` (phase
4: the full-width engine in both modes, its calibrated gate, against the
"torch" attention, its launches per stage-chunk), `beats_engine` (phase
4b: two BEATs stages on the engine, their mha_packed_relpos and
epilogue launches counted), `train_alone`
(mha_packed_trainable alone at (16, 1214, 768)), `train` (the
full-width training step of both routes, which logs its ms per step),
`loop` (the training loop, which logs its ms per step) and `serving`
(phase 8: int8 inference, streaming and the serving CLIs, which logs
windows/s, emit latency and mha_packed at the streaming buckets), `audio`
(phase 9's native library, resamplers, loader and vocoder) and `parallel`
(phase 9's fold- and trial-parallel training, which sets its ms per step
beside the `loop` phase's when that ran first, else beside nan) and
`workflow` (phase 10: the data preparation, evaluation and analysis CLIs
as subprocesses, and the adapted stages served) and `mesh` (phase 11:
ranks of a process group on the one card, one NCCL rank and two gloo
ranks, against one device).
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
PHASES = ("relpos", "epilogue", "engine", "beats_engine", "train_alone",
          "train", "loop", "serving", "audio", "parallel", "workflow", "mesh")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("smoke_phase: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from zenker_audio_detection_tpu_torch.infer import cascade as C
    from zenker_audio_detection_tpu_torch.models import ast as ast_mod
    from zenker_audio_detection_tpu_torch.ops import _cuda
    from zenker_audio_detection_tpu_torch.ops import attention as A

    parser = argparse.ArgumentParser()
    parser.add_argument("--phases", nargs="+", choices=PHASES,
                        default=["train"])
    args = parser.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _cuda.build_all()
    loop_ms = float("nan")
    for phase in args.phases:
        t0 = time.perf_counter()
        if phase == "relpos":
            print(chip_smoke.phase_relpos(A, torch), flush=True)
        elif phase == "epilogue":
            print(chip_smoke.phase_epilogue(C, ast_mod, torch), flush=True)
        elif phase == "beats_engine":
            chip_smoke.phase_beats_engine(A, C, torch)
        elif phase == "engine":
            chip_smoke.phase_engine(A, C, ast_mod, torch,
                                    torch.cuda.get_device_name(0))
        elif phase == "train_alone":
            chip_smoke.phase_train_alone(A, torch)
        elif phase == "train":
            chip_smoke.phase_train(A, ast_mod, torch)
        elif phase == "loop":
            loop_ms = chip_smoke.phase_train_loop(A, C, ast_mod, torch, smi)
        elif phase == "audio":
            chip_smoke.phase_audio_io(torch, smi)
        elif phase == "parallel":
            chip_smoke.phase_parallel(A, ast_mod, torch, smi, loop_ms)
        elif phase == "workflow":
            chip_smoke.phase_workflow(A, C, ast_mod, torch)
        elif phase == "mesh":
            chip_smoke.phase_mesh(C, ast_mod, torch, smi)
        else:
            print(chip_smoke.phase_serving(A, C, ast_mod, torch, smi),
                  flush=True)
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
