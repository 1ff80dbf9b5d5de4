#!/usr/bin/env python3
"""Does the JAX package's first training update raise the loss too?

    python3 tools/first_update_probe.py [--micro 4]

One f32 training update of the full-width AST (ASTConfig(): 12 layers,
H = 768, 1214 tokens) in the JAX package and in the port, on the CPU, from
one parameter tree (the port's `init_params` at seed 7, carried to the JAX
package in its layout and back through `params_from_jax`) and on one
batch: chip_smoke.py's training phase's batch (16 seeded feature maps,
balanced labels, numpy seed 8), loss (stage1_loss, focal gamma 2, label
smoothing 0.07) and optimizer (make_optimizer(1e-5, 5 steps, no warmup,
weight decay 0.013, beta2 0.97)). The batch goes through in micro-batches
of `--micro` with each package's gradient accumulation (the mean of equal
micro-batch means is the batch mean, so the update is the batch-16 one up
to the order of the sums), which bounds the host memory to a few GB.

Prints the loss before the update and after it in each package, the
largest parameter difference after it, and one JSON line last. Run from the
repository's root; it needs JAX, so it runs where the JAX package's tests
run, not on the machine with the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path.cwd()))
SEED_PARAMS, SEED_BATCH, BATCH = 7, 8, 16
OPT = dict(learning_rate=1e-5, total_steps=5, warmup_ratio=0.0,
           weight_decay=0.013, beta2=0.97)
GAMMA, SMOOTHING = 2.0, 0.07


def batch():
    """chip_smoke.py's training batch (phase_train)."""
    from zenker_audio_detection_tpu_torch.models import ast as ast_mod

    cfg = ast_mod.ASTConfig()
    rng = np.random.default_rng(SEED_BATCH)
    feats = rng.standard_normal(
        (BATCH, cfg.max_length, cfg.num_mel_bins)).astype(np.float32)
    labels = rng.permutation(np.arange(BATCH) % 2)
    return feats, labels


def run_jax(tree, feats, labels, micro: int) -> dict:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from zenker_audio_detection_tpu.models import ast as jast
    from zenker_audio_detection_tpu.train import losses, optim, steps

    cfg = jast.ASTConfig()
    params = jax.tree.map(jnp.asarray, tree)

    def loss(lg, y):
        return losses.stage1_loss(lg, y, GAMMA, SMOOTHING)

    tx = optim.make_optimizer(**OPT)
    grad_step, apply_step = steps.make_accum_steps(tx, cfg, loss,
                                                   dtype=jnp.float32)
    eval_step = steps.make_eval_step(cfg, dtype=jnp.float32)
    opt_state = tx.init(params)
    buf = jax.tree.map(jnp.zeros_like, params)
    before = []
    for s in range(0, BATCH, micro):
        buf, lv, _ = grad_step(params, buf, jnp.asarray(feats[s:s + micro]),
                               jnp.asarray(labels[s:s + micro]))
        before.append(float(lv))
    params, opt_state, _ = apply_step(params, opt_state, buf,
                                      float(BATCH // micro))
    logits = np.concatenate([np.asarray(eval_step(
        params, jnp.asarray(feats[s:s + micro])))
        for s in range(0, BATCH, micro)])
    after = float(loss(jnp.asarray(logits), jnp.asarray(labels)))
    return {"before": float(np.mean(before)), "after": after,
            "params": jax.tree.map(np.asarray, params)}


def run_port(tree, feats, labels, micro: int) -> dict:
    import torch

    from zenker_audio_detection_tpu_torch.models import ast as ast_mod
    from zenker_audio_detection_tpu_torch.models import convert
    from zenker_audio_detection_tpu_torch.train import losses, optim, steps

    cfg = ast_mod.ASTConfig()
    params = convert.params_from_jax(tree)

    def loss(lg, y):
        return losses.stage1_loss(lg, y, GAMMA, SMOOTHING)

    tx = optim.make_optimizer(**OPT)
    grad_step, apply_step = steps.make_accum_steps(tx, cfg, loss,
                                                   dtype=torch.float32)
    eval_step = steps.make_eval_step(cfg, dtype=torch.float32)
    opt_state = tx.init(params)
    buf = optim.tree_map(torch.zeros_like, params)
    before = []
    for s in range(0, BATCH, micro):
        buf, lv, _ = grad_step(params, buf, torch.from_numpy(feats[s:s + micro]),
                               torch.from_numpy(labels[s:s + micro]))
        before.append(float(lv))
    params, opt_state, _ = apply_step(params, opt_state, buf,
                                      float(BATCH // micro))
    logits = torch.cat([eval_step(params, torch.from_numpy(feats[s:s + micro]))
                        for s in range(0, BATCH, micro)])
    after = float(loss(logits, torch.from_numpy(labels)))
    return {"before": float(np.mean(before)), "after": after,
            "params": convert.params_to_numpy(params)}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--micro", type=int, default=4,
                        help="micro-batch size (divides 16)")
    args = parser.parse_args()
    if BATCH % args.micro:
        parser.error("--micro must divide 16")
    from zenker_audio_detection_tpu_torch.models import ast as ast_mod
    from zenker_audio_detection_tpu_torch.models import convert

    tree = convert.params_to_numpy(ast_mod.init_params(
        np.random.default_rng(SEED_PARAMS), ast_mod.ASTConfig()))
    feats, labels = batch()
    found = {}
    for name, fn in (("jax", run_jax), ("port", run_port)):
        t0 = time.perf_counter()
        found[name] = fn(tree, feats, labels, args.micro)
        print(f"[probe] {name}: loss {found[name]['before']:.6f} before the "
              f"update, {found[name]['after']:.6f} after it "
              f"({time.perf_counter() - t0:.1f} s on the CPU)", flush=True)
    from zenker_audio_detection_tpu_torch.models.convert import _flatten_tree

    a = _flatten_tree(found["jax"].pop("params"))
    b = _flatten_tree(found["port"].pop("params"))
    diffs = {k: float(np.abs(a[k] - b[k]).max()) for k in a}
    worst = max(diffs, key=diffs.get)
    print(f"[probe] parameters after the update: largest difference "
          f"{diffs[worst]:.3g} ({worst}); the others at most "
          f"{max(v for k, v in diffs.items() if k != worst):.3g}", flush=True)
    rises = {k: v["after"] > v["before"] for k, v in found.items()}
    print(json.dumps({**found, "rises": rises, "max_param_diff": diffs[worst],
                      "max_param_diff_leaf": worst, "micro": args.micro}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
