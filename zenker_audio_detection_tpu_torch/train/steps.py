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

Data parallelism (`mesh`, parallel/mesh.py): every rank holds the global
batch and runs the forward on its contiguous share of the rows
(`sharded_value_and_grad`). The logits are gathered into the global batch
and the loss is the global batch's, so the batch-level statistics of the
losses (the stage-2 focal α from the label mean, the weighted CE's
Σ w[y], a masked mean's valid count) are those of JAX's GSPMD step, not a
mean of per-rank losses; each rank then back-propagates its own rows' share
of d(loss)/d(logits) and the parameter gradients are summed over the mesh.
A batch whose rows do not divide over the mesh (a tail batch) runs whole
on every rank, as JAX runs it replicated.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import ast as ast_mod
from ..parallel import mesh as pmesh
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


def sharded_value_and_grad(logits_fn: Callable, loss: Callable, params,
                           local_inputs: tuple, loss_args: tuple, mesh,
                           dim: int = 0):
    """`value_and_grad` of `loss(global_logits, *loss_args)` where this
    rank computes `logits_fn(params, *local_inputs)`, its contiguous share
    of the global logits along `dim`: ((loss, aux), grads), the gradients
    summed over `mesh` (the global batch's gradient on every rank). `loss`
    returns (scalar, aux), and aux comes back with the global logits'
    values when it is them."""
    paths = [path for path, _ in optim.tree_items(params)]
    leaves = [leaf.detach().requires_grad_()
              for _, leaf in optim.tree_items(params)]
    with torch.enable_grad():
        local = logits_fn(optim.tree_from_items(zip(paths, leaves)),
                          *local_inputs)
    glob = pmesh.gather_rows(local.detach(), mesh, dim).requires_grad_()
    with torch.enable_grad():
        loss_val, aux = loss(glob, *loss_args)
        (d_glob,) = torch.autograd.grad(loss_val, glob)
    with full_f32():
        grads = torch.autograd.grad(
            local, leaves, grad_outputs=pmesh.local_rows(d_glob, mesh, dim),
            allow_unused=True)
    grads = [torch.zeros_like(leaf) if g is None else g
             for leaf, g in zip(leaves, grads)]
    grads = pmesh.all_reduce_grads(grads, mesh)
    aux = aux.detach() if isinstance(aux, torch.Tensor) else aux
    return (loss_val.detach(), aux), optim.tree_from_items(zip(paths, grads))


def _divides(n: int, mesh) -> bool:
    return mesh is not None and n % pmesh.mesh_size(mesh) == 0


def make_value_and_grad(config: ast_mod.ASTConfig, loss: Callable,
                        dtype=torch.bfloat16, remat: bool = True,
                        remat_policy: str = "full", mesh=None,
                        attention_impl: str = "torch"):
    """vg(params, feats, labels) -> ((loss, logits), grads) of the batch's
    mean loss. With `mesh`, feats and labels are the global batch: when
    its rows divide over the mesh each rank runs its share
    (`sharded_value_and_grad`), else (a tail batch) the whole batch.
    `attention_impl` "kernel" runs the Hopper kernels' trainable route."""

    def forward(params, feats):
        return ast_mod.forward(params, feats, config, dtype=dtype,
                               remat=remat, remat_policy=remat_policy,
                               attention_impl=attention_impl)

    def on_logits(logits, labels):
        return loss(logits, labels), logits

    def whole(params, feats, labels):
        return on_logits(forward(params, feats), labels)

    def vg(params, feats, labels):
        device = labels.device
        if not _divides(len(labels), mesh):
            return value_and_grad(whole, params, feats.to(device), labels)
        local = pmesh.local_rows(feats, mesh).to(device)
        return sharded_value_and_grad(forward, on_logits, params, (local,),
                                      (labels,), mesh)

    return vg


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
                    remat_policy: str = "full", mesh=None):
    """train_step(params, opt_state, feats, labels) -> (params', opt_state',
    loss, logits): one optimizer update on the batch's mean loss. With
    `mesh` (data parallel, module docstring) every rank passes the global
    batch (feats may stay on the host: a rank moves only its rows to the
    labels' device) and gets the global loss and logits; the parameters
    stay replicated, since every rank applies the same summed gradient."""
    vg = make_value_and_grad(config, loss, dtype, remat, remat_policy, mesh)

    def train_step(params, opt_state, feats, labels):
        (loss_val, logits), grads = vg(params, feats, labels)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optim.apply_updates(params, updates)
        return params, opt_state, loss_val, logits

    return train_step


def make_accum_steps(tx: optim.AdamW, config: ast_mod.ASTConfig,
                     loss: Callable, dtype=torch.bfloat16, remat: bool = True,
                     remat_policy: str = "full", mesh=None):
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
    whole batch's by design. `mesh`: each micro-batch as make_train_step
    takes a batch."""
    vg = make_value_and_grad(config, loss, dtype, remat, remat_policy, mesh)

    def grad_step(params, grad_buf, feats, labels):
        (loss_val, logits), grads = vg(params, feats, labels)
        grad_buf = optim.tree_map(torch.add, grad_buf, grads)
        return grad_buf, loss_val, logits

    def apply_step(params, opt_state, grad_buf, n_micro):
        grads = optim.tree_map(lambda g: g / n_micro, grad_buf)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optim.apply_updates(params, updates)
        return params, opt_state, optim.tree_map(torch.zeros_like, grads)

    return grad_step, apply_step


def make_eval_step(config: ast_mod.ASTConfig, dtype=torch.bfloat16,
                   mesh=None, device=None):
    """eval_step(params, feats) -> f32 logits, without autograd. With
    `mesh`, feats is the global chunk on every rank (on the host or on
    `device`): a chunk whose rows divide over the mesh is sharded and its
    logits gathered, another runs whole; every rank gets every row."""

    def forward(params, feats):
        with torch.no_grad():
            return ast_mod.forward(params, feats, config, dtype=dtype)

    if mesh is None:
        return forward

    def eval_step(params, feats):
        if not _divides(len(feats), mesh):
            return forward(params, feats.to(device))
        local = forward(params, pmesh.local_rows(feats, mesh).to(device))
        return pmesh.gather_rows(local, mesh)

    return eval_step
