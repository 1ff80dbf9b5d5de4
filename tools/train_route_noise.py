#!/usr/bin/env python3
"""How far apart equally precise training routes land, on one NVIDIA GPU.

    python3 tools/train_route_noise.py [--seeds 7 17 27 37 47]
        [--routes torch torch_flash torch_reversed kernel]

chip_smoke.py's training phase holds the "kernel" route's losses and
gradients to the "torch" route's at the same parameters. This tool measures how far apart routes that compute the
same function with other roundings land on the same data: for each seed s
(weights from numpy seed s, the batch from seed s + 1; chip_smoke.py's
seeds), at full width (ASTConfig(), batch 16, bf16, remat, stage1_loss(2.0,
0.07), chip_smoke.py's optimizer), five steps of each route, from the same
weights on the same batch:

  torch          the plain attention (mha_packed_reference), as chip_smoke;
  torch_flash    the same, but the unnormalised exp(s - m) is rounded to bf16
                 and the product divided by the row sum afterwards, the
                 kernels' order;
  torch_reversed the torch route on the batch in reverse order: the same
                 loss and gradients, other summation orders;
  kernel         mha_packed_trainable.

Prints per seed and route the loss before each step and after the last,
each loss's distance from the torch route's, the relative norm of the
difference of the first-step gradients and the share of gradient elements
whose sign differs from the torch route's (Adam's first step moves every
parameter by about the learning rate in the direction of that sign). Beside
these trajectory readings, the same-point readings of chip_smoke.py's
phase 6: the route's own five updates, and at each parameter point it
visits (before each update, after the last) both its loss and gradients and
the torch route's at those parameters, their loss difference and the
relative norm of their gradients' difference. Prints the card's name and
power limit first and one JSON line last. Run from a checkout's root; it
imports the package and chip_smoke.py found there.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd()))
ROUTES = ("torch", "torch_flash", "torch_reversed", "kernel")
STEPS = 5
OPT = dict(learning_rate=1e-5, total_steps=STEPS, warmup_ratio=0.0,
           weight_decay=0.013, beta2=0.97)  # chip_smoke.py's TRAIN_OPT


def flash_order(q, k, v, num_heads):
    """mha_packed_reference's function with the kernels' rounding order:
    p = exp(s - m) in f32 rounded to the input dtype for the product, the
    product divided by the f32 row sum."""
    import torch

    B, S, H = q.shape
    D = H // num_heads

    def heads(x):
        return x.reshape(B, S, num_heads, D).transpose(1, 2).float()

    s = torch.matmul(heads(q), heads(k).transpose(-1, -2)) / math.sqrt(D)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    del s
    o = torch.matmul(p.to(q.dtype).float(), heads(v)) / p.sum(-1, keepdim=True)
    return o.to(q.dtype).transpose(1, 2).reshape(B, S, H)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("train_route_noise: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from zenker_audio_detection_tpu_torch.models import ast as ast_mod
    from zenker_audio_detection_tpu_torch.ops import attention as A
    from zenker_audio_detection_tpu_torch.train import losses, optim, steps

    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, nargs="+",
                        default=[7, 17, 27, 37, 47])
    parser.add_argument("--routes", nargs="+", choices=ROUTES,
                        default=list(ROUTES))
    args = parser.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    plain = A.mha_packed_reference
    cfg = ast_mod.ASTConfig()
    tx = optim.make_optimizer(**OPT)

    def loss_fn(route):
        impl = "kernel" if route == "kernel" else "torch"

        def fn(p, f, y):
            logits = ast_mod.forward(p, f, cfg, dtype=torch.bfloat16,
                                     remat=True, attention_impl=impl)
            return losses.stage1_loss(logits, y, 2.0, 0.07), logits
        return fn

    def vg(route):
        """(params, feats, labels) -> (loss, grads) of `route`."""
        fn = loss_fn(route)

        def run_vg(p, f, y):
            A.mha_packed_reference = flash_order if route == "torch_flash" \
                else plain
            if route == "torch_reversed":
                f, y = f.flip(0), y.flip(0)
            try:
                (lv, _), g = steps.value_and_grad(fn, p, f, y)
            finally:
                A.mha_packed_reference = plain
            return lv, g
        return run_vg

    def run(route, params0, feats, labels):
        """STEPS steps: the loss before each and after the last, and the
        first step's gradients."""
        step_vg = vg(route)
        p, o, out, first = params0, tx.init(params0), [], None
        for _ in range(STEPS):
            lv, g = step_vg(p, feats, labels)
            u, o = tx.update(g, o, p)
            p = optim.apply_updates(p, u)
            out.append(float(lv))
            first = g if first is None else first
        with torch.no_grad():
            A.mha_packed_reference = flash_order if route == "torch_flash" \
                else plain
            f, y = ((feats.flip(0), labels.flip(0))
                    if route == "torch_reversed" else (feats, labels))
            out.append(float(loss_fn(route)(p, f, y)[0]))
            A.mha_packed_reference = plain
        return out, first

    results = {}
    for seed in args.seeds:
        params0, feats, labels = chip_smoke.route_inputs(ast_mod, cfg, seed,
                                                         16, "cuda")
        base, g0 = run("torch", params0, feats, labels)
        leaves0 = [g for _, g in optim.tree_items(g0)]
        norm0 = math.sqrt(sum(float((g.float() ** 2).sum()) for g in leaves0))
        total = sum(g.numel() for g in leaves0)
        for route in args.routes:
            ls, g = (base, g0) if route == "torch" else run(
                route, params0, feats, labels)
            leaves = [x for _, x in optim.tree_items(g)]
            rel = math.sqrt(sum(float(((a.float() - b.float()) ** 2).sum())
                                for a, b in zip(leaves, leaves0))) / norm0
            flips = sum(int((torch.sign(a) != torch.sign(b)).sum())
                        for a, b in zip(leaves, leaves0)) / total
            diffs = [abs(a - b) for a, b in zip(ls, base)]
            same = ([] if route == "torch" else chip_smoke.same_point_readings(
                {"kernel": vg(route), "torch": vg("torch")}, params0, feats,
                labels, STEPS))
            results.setdefault(str(seed), {})[route] = {
                "losses": ls, "diffs": diffs, "first_update_diff": diffs[1],
                "other_max_diff": max(diffs[:1] + diffs[2:]),
                "grad_rel": rel, "sign_flips": flips,
                "same_point_loss_diffs": [r["loss_diff"] for r in same],
                "same_point_grad_rels": [r["grad_rel"] for r in same]}
            sp_loss = [float(f"{r['loss_diff']:.3g}") for r in same]
            sp_grad = [float(f"{r['grad_rel']:.3g}") for r in same]
            print(f"[noise] seed {seed} {route}: losses "
                  f"{[round(x, 6) for x in ls]}; from torch: right after the "
                  f"first update {diffs[1]:.3g}, elsewhere at most "
                  f"{max(diffs[:1] + diffs[2:]):.3g}; first-step gradients "
                  f"{rel:.3g} apart, {100 * flips:.3f} % of signs differ; at "
                  f"the same points (before each update, after the last): "
                  f"loss differences {sp_loss}, gradients {sp_grad} apart",
                  flush=True)
        del params0, g0, leaves0
        torch.cuda.empty_cache()
    print(json.dumps({"results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
