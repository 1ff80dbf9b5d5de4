"""Fine-tuning steps as the HF Trainer takes them, plain float32.

The batch's mean cross-entropy; the gradient clipped to a global norm of
at most `max_grad_norm`; AdamW with both moments bias-corrected, eps
outside the square root, and decoupled weight decay on every leaf but
biases, LayerNorm parameters and the head's LayerNorm; the learning rate
warmed up linearly over ceil(warmup x total) steps and then decayed
linearly to zero, read at the step count before the update.
"""

from __future__ import annotations

import math

import torch

from . import ast


def leaves(tree: dict, prefix: str = ""):
    """(dotted name, tensor) of every leaf, in the dict's order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def rebuild(tree: dict, values: dict, prefix: str = "") -> dict:
    return {k: rebuild(v, values, f"{prefix}{k}.") if isinstance(v, dict)
            else values[prefix + k] for k, v in tree.items()}


def decays(name: str) -> bool:
    parts = name.split(".")
    return parts[-1] != "bias" and not any(
        p in ("ln1", "ln2", "ln_final", "ln") for p in parts)


def learning_rate(opt: dict, count: int) -> float:
    warm = math.ceil(opt["total_steps"] * opt["warmup_ratio"])
    if count < warm:
        frac = count / max(1, warm)
    else:
        frac = (opt["total_steps"] - count) / max(1, opt["total_steps"] - warm)
    return opt["learning_rate"] * min(1.0, max(0.0, frac))


def loss_and_grads(params: dict, feats, labels, config: dict, rows: int,
                   quant: str | None = None):
    """The batch's mean cross-entropy, its gradient by leaf and the
    logits, taken in blocks of `rows` rows so that the activations fit."""
    names = [n for n, _ in leaves(params)]
    grads = {n: torch.zeros_like(p) for n, p in leaves(params)}
    total, outs = 0.0, []
    for i in range(0, len(labels), rows):
        vals = {n: p.detach().requires_grad_() for n, p in leaves(params)}
        with torch.enable_grad():
            logits, _ = ast.forward(rebuild(params, vals), feats[i: i + rows],
                                    config, quant)
            loss = torch.nn.functional.cross_entropy(
                logits, labels[i: i + rows], reduction="sum")
            with ast.true_f32():
                g = torch.autograd.grad(loss, [vals[n] for n in names])
        total += float(loss.detach())
        outs.append(logits.detach())
        for n, gi in zip(names, g):
            grads[n] += gi
    n = len(labels)
    return total / n, {k: g / n for k, g in grads.items()}, torch.cat(outs)


def adamw_step(params: dict, state: dict, grads: dict, opt: dict):
    """One update: (new params, new state). state: {"count", "mu", "nu"}
    by leaf name."""
    norm = math.sqrt(sum(float((g * g).sum()) for g in grads.values()))
    if norm >= opt["max_grad_norm"]:
        grads = {k: g / norm * opt["max_grad_norm"] for k, g in grads.items()}
    b1, b2, eps = opt["beta1"], opt["beta2"], opt["eps"]
    count = state["count"] + 1
    lr = learning_rate(opt, state["count"])
    mu, nu, new = {}, {}, {}
    for name, p in leaves(params):
        g = grads[name]
        mu[name] = b1 * state["mu"][name] + (1 - b1) * g
        nu[name] = b2 * state["nu"][name] + (1 - b2) * g * g
        u = (mu[name] / (1 - b1 ** count)) / (
            torch.sqrt(nu[name] / (1 - b2 ** count)) + eps)
        if decays(name):
            u = u + opt["weight_decay"] * p
        new[name] = p - lr * u
    return rebuild(params, new), {"count": count, "mu": mu, "nu": nu}


def init_state(params: dict) -> dict:
    zeros = {n: torch.zeros_like(p) for n, p in leaves(params)}
    return {"count": 0, "mu": zeros,
            "nu": {n: torch.zeros_like(p) for n, p in leaves(params)}}
