"""Optimizer and LR schedule matching the reference's HF Trainer settings.

The port of the JAX package's `train/optim.py`. The reference trains with
`adamw_torch_fused`, HF's linear warmup-then-decay schedule and
`max_grad_norm=1.0`; the JAX package states that as the optax chain

    clip_by_global_norm(max_norm) -> scale_by_adam(b1, b2, eps)
      -> add_decayed_weights(wd, mask) -> scale(-lr(count))

and this module restates the same chain on nested dicts of f32 tensors,
step for step and in the same f32 arithmetic, with the optax API shape:
`opt.init(params) -> state`, `opt.update(grads, state, params) -> (updates,
state)`, `apply_updates(params, updates)`. It is functional, like optax:
nothing is updated in place. What `torch.optim.AdamW` with
`clip_grad_norm_` would do differently, and this does not:
  * the global norm clips only when it is at least max_norm, and then
    scales by max_norm / norm exactly (`clip_grad_norm_` adds 1e-6 to the
    norm);
  * eps is added outside the square root of the bias-corrected second
    moment, and both moments are bias-corrected with the step count;
  * weight decay adds wd * p of the pre-update parameter before the step
    size multiplies;
  * the schedule is read at the count before it is incremented, so the
    first update uses lr(0).
`adamw_init`/`adamw_apply` restate the same chain with the learning rate,
weight decay and beta2 as tensors (one per fold or trial under
`torch.func.vmap`), in the JAX functions' arithmetic order; the fold- and
trial-parallel trainers vmap them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

_NO_DECAY = ("ln1", "ln2", "ln_final", "ln")


def linear_schedule(learning_rate: float, total_steps: int,
                    warmup_ratio: float = 0.1) -> Callable[[int], float]:
    """Linear warmup over ceil(warmup_ratio * total_steps) steps, then linear
    decay to 0 (transformers' get_linear_schedule_with_warmup), computed in
    f32 as the JAX schedule is."""
    warmup_steps = math.ceil(total_steps * warmup_ratio)
    f32 = torch.float32

    def schedule(step) -> float:
        step = torch.tensor(float(step), dtype=f32)
        warm = step / max(1.0, warmup_steps)
        decay = (total_steps - step) / max(1.0, total_steps - warmup_steps)
        frac = torch.clamp(torch.where(step < warmup_steps, warm, decay),
                           0.0, 1.0)
        return float(torch.tensor(learning_rate, dtype=f32) * frac)

    return schedule


def tree_map(fn, *trees):
    """fn applied leaf by leaf over nested dicts of one structure."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def tree_items(tree, prefix=()):
    """(path, leaf) for every leaf of a nested dict, path a tuple of keys,
    in the dict's order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tree_from_items(items) -> dict:
    """The nested dict of (path, leaf) pairs: `tree_items` undone."""
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def decay_mask(params) -> dict:
    """True (apply weight decay) for every leaf except biases and everything
    under a LayerNorm (`ln1`, `ln2`, `ln_final`, `ln`), mirroring HF's
    name-based exclusion. `pos_embed`, `cls_token` and `dist_token` are
    decayed."""

    def walk(tree, under_ln):
        return {k: (walk(v, under_ln or k in _NO_DECAY)
                    if isinstance(v, dict)
                    else not (k == "bias" or under_ln or k in _NO_DECAY))
                for k, v in tree.items()}

    return walk(params, False)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(x.float() * x.float())
                          for _, x in tree_items(tree)))


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The optax chain of the module docstring. The state is a dict
    {"count": int, "mu": tree, "nu": tree}; `count` is the number of
    updates made, which the schedule and the bias correction read."""
    schedule: Callable[[int], float]
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1e-8
    max_grad_norm: float | None = 1.0

    def init(self, params) -> dict:
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, grads, state, params):
        b1, b2 = self.beta1, self.beta2
        if self.max_grad_norm is not None:
            g_norm = global_norm(grads)
            if not bool(g_norm < self.max_grad_norm):
                grads = tree_map(lambda g: (g / g_norm.to(g.dtype))
                                 * self.max_grad_norm, grads)
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads,
                      state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads,
                      state["nu"])
        count = state["count"] + 1
        f32 = torch.float32
        bc1 = 1 - torch.tensor(b1, dtype=f32) ** torch.tensor(count, dtype=f32)
        bc2 = 1 - torch.tensor(b2, dtype=f32) ** torch.tensor(count, dtype=f32)
        step = torch.tensor(-self.schedule(state["count"]), dtype=f32)
        mask = decay_mask(params)

        def one(m, v, p, decay):
            bc1_, bc2_ = bc1.to(m.device), bc2.to(m.device)
            u = (m / bc1_) / (torch.sqrt(v / bc2_) + self.eps)
            if decay:
                u = u + self.weight_decay * p
            return step.to(u.device) * u

        updates = tree_map(one, mu, nu, params, mask)
        return updates, {"count": count, "mu": mu, "nu": nu}


def apply_updates(params, updates):
    """p + u, leaf by leaf, in the parameter's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def make_optimizer(learning_rate: float, total_steps: int,
                   warmup_ratio: float = 0.1, weight_decay: float = 0.01,
                   beta1: float = 0.9, beta2: float = 0.98,
                   eps: float = 1e-8,
                   max_grad_norm: float | None = 1.0) -> AdamW:
    """HF-Trainer-equivalent AdamW (max_grad_norm=1.0 is the HF default)."""
    return AdamW(linear_schedule(learning_rate, total_steps, warmup_ratio),
                 weight_decay, beta1, beta2, eps, max_grad_norm)


# ---------------------------------------------------------------------------
# AdamW with tensor hyperparameters, for the fold- and trial-parallel steps
# ---------------------------------------------------------------------------
#
# `make_optimizer` fixes (beta2, weight_decay, schedule) when it is built,
# which suits one configuration per step. The parallel trainers vmap ONE
# update over folds or trials whose learning rates (and, for trials, weight
# decays and beta2) differ, so those are tensors here. The arithmetic is the
# JAX package's `adamw_apply`, in its order: clip by the global norm, the
# moments, the bias corrections in f32, then p - lr * (m̂ / (sqrt(v̂) + eps)
# + wd * mask * p).


def adamw_init(params) -> dict:
    """{"count": 0-d int32 zero, "mu": zeros, "nu": zeros}, on the
    parameters' device."""
    device = next(leaf for _, leaf in tree_items(params)).device
    return {"count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params)}


def adamw_apply(params, state, grads, *, lr, weight_decay, beta2,
                beta1: float = 0.9, eps: float = 1e-8,
                max_grad_norm: float = 1.0, mask_tree=None):
    """(new_params, new_state). lr, weight_decay and beta2 may be tensors
    (0-d, or batched under vmap); lr is the step size already scheduled.
    mask_tree: decay_mask(params) (Python bools), computed by the caller
    when params are batched."""
    if mask_tree is None:
        mask_tree = decay_mask(params)
    g_norm = global_norm(grads)
    grads = tree_map(
        lambda g: torch.where(g_norm < max_grad_norm, g,
                              (g / g_norm.to(g.dtype)) * max_grad_norm),
        grads)
    count = state["count"] + 1
    mu = tree_map(lambda m, g: beta1 * m + (1.0 - beta1) * g,
                  state["mu"], grads)
    nu = tree_map(lambda v, g: beta2 * v + (1.0 - beta2) * g * g,
                  state["nu"], grads)
    bc1 = 1.0 - beta1 ** count.float()
    bc2 = 1.0 - beta2 ** count.float()
    new_params = tree_map(
        lambda p, m, v, use_wd: p - lr * (
            (m / bc1) / (torch.sqrt(v / bc2) + eps)
            + (weight_decay if use_wd else 0.0) * p),
        params, mu, nu, mask_tree)
    return new_params, {"count": count, "mu": mu, "nu": nu}
