"""Train and eval steps, the port of the JAX package's `train/steps.py`.

The signatures and defaults are the JAX ones (bf16 compute, `remat=True`).
Parameters are f32 masters, a nested dict of tensors; the forward casts
them to the compute dtype as it goes (`models.ast._dense`), as the JAX step
does, so `models.ast.cast_params`, which pre-casts for inference, is not
used here. The steps are functional like the JAX ones: they return new
parameters and optimizer state and leave their arguments as they were.

The steps run the model's "torch" attention, as the JAX trainer's steps run
its default "xla" attention. A step with the Hopper kernel is
`value_and_grad` over a loss function whose forward passes
`attention_impl="kernel"`.

The backward runs inside `full_f32()`: the forward's own `full_f32()` has
exited by then, and cuDNN would otherwise compute the f32 patch
convolution's weight gradient in TF32.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import ast as ast_mod
from ..utils.precision import full_f32
from . import optim


def value_and_grad(loss_fn: Callable, params, *args):
    """`jax.value_and_grad(loss_fn, has_aux=True)(params, *args)`:
    ((loss, aux), grads) with grads shaped like params. The backward runs
    inside `full_f32()`; a leaf the loss does not reach gets a zero
    gradient, as in JAX."""
    paths = [path for path, _ in optim.tree_items(params)]
    leaves = [leaf.detach().requires_grad_()
              for _, leaf in optim.tree_items(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(optim.tree_from_items(zip(paths, leaves)), *args)
        with full_f32():
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g
             for leaf, g in zip(leaves, grads)]
    aux = aux.detach() if isinstance(aux, torch.Tensor) else aux
    return (loss.detach(), aux), optim.tree_from_items(zip(paths, grads))


def make_loss_fn(config: ast_mod.ASTConfig, loss: Callable,
                 dtype=torch.bfloat16, remat: bool = True,
                 remat_policy: str = "full"):
    """loss(logits, labels) -> scalar, lifted to a params-first objective
    that returns (loss, logits)."""

    def loss_fn(params, feats, labels):
        logits = ast_mod.forward(params, feats, config, dtype=dtype,
                                 remat=remat, remat_policy=remat_policy)
        return loss(logits, labels), logits

    return loss_fn


def make_train_step(tx: optim.AdamW, config: ast_mod.ASTConfig,
                    loss: Callable, dtype=torch.bfloat16, remat: bool = True,
                    remat_policy: str = "full"):
    """train_step(params, opt_state, feats, labels) -> (params', opt_state',
    loss, logits): one optimizer update on the batch's mean loss."""
    loss_fn = make_loss_fn(config, loss, dtype, remat, remat_policy)

    def train_step(params, opt_state, feats, labels):
        (loss_val, logits), grads = value_and_grad(loss_fn, params, feats,
                                                   labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optim.apply_updates(params, updates)
        return params, opt_state, loss_val, logits

    return train_step


def make_accum_steps(tx: optim.AdamW, config: ast_mod.ASTConfig,
                     loss: Callable, dtype=torch.bfloat16, remat: bool = True,
                     remat_policy: str = "full"):
    """Gradient accumulation as two steps:

      grad_step(params, grad_buf, feats, labels) -> (grad_buf', loss, logits)
          one micro-batch: adds d(mean micro-loss)/d(params) to the buffer;
      apply_step(params, opt_state, grad_buf, n_micro) -> (params', opt',
          zeroed buffer): one optimizer update on the micro-mean of the
          accumulated gradients.

    Equal-sized micro-batches reproduce one N * micro batch (up to the
    order of the sums) for per-sample-mean losses; a smaller tail
    micro-batch weighs as much as a full one (the HF Trainer
    gradient_accumulation_steps convention). The stage-2 focal loss takes
    its class α per micro-batch, so its accumulated gradients differ from a
    whole batch's by design."""
    loss_fn = make_loss_fn(config, loss, dtype, remat, remat_policy)

    def grad_step(params, grad_buf, feats, labels):
        (loss_val, logits), grads = value_and_grad(loss_fn, params, feats,
                                                   labels)
        grad_buf = optim.tree_map(torch.add, grad_buf, grads)
        return grad_buf, loss_val, logits

    def apply_step(params, opt_state, grad_buf, n_micro):
        grads = optim.tree_map(lambda g: g / n_micro, grad_buf)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optim.apply_updates(params, updates)
        return params, opt_state, optim.tree_map(torch.zeros_like, grads)

    return grad_step, apply_step


def make_eval_step(config: ast_mod.ASTConfig, dtype=torch.bfloat16):
    """eval_step(params, feats) -> f32 logits, without autograd."""

    def eval_step(params, feats):
        with torch.no_grad():
            return ast_mod.forward(params, feats, config, dtype=dtype)

    return eval_step
