"""Runs over a mesh, one call in every rank of a process group.

`parallel/launch.spawn` runs each function below in every rank and returns
rank 0's result, so the tests (tests/test_torch_mesh.py,
tests/test_torch_multidevice.py) and `chip_smoke.py` phase 11 compare what
the ranks computed together with a single-device run in the caller. Every
result carries what each rank saw where it matters (its kernel launches,
whether its parameters stayed equal to the first rank's), gathered to rank
0. Inputs are numpy arrays or the port's own dataclasses, which pickle into
the ranks; a stage may also be named by its seed (`seeded_spec`), so that
a full-width model is made in each rank instead of being pickled.
"""

from __future__ import annotations

import numpy as np
import torch

from . import mesh as pmesh


def seeded_spec(seed: int, config=None, mean: float | None = None,
                std: float | None = None, labels=("Idle", "Swallow"),
                head: dict | None = None):
    """A stage of random f32 weights from `init_params(default_rng(seed))`
    (the full-width `ASTConfig()` by default), the dataset's fallback
    normalization unless given; `head` ({"kernel", "bias"} numpy arrays)
    replaces the head's dense layer."""
    from ..infer import cascade as C
    from ..models import ast as ast_mod
    from ..ops import fbank as F

    config = config or ast_mod.ASTConfig()
    params = ast_mod.init_params(np.random.default_rng(seed), config)
    if head is not None:
        params["head"]["dense"] = {k: torch.from_numpy(np.array(v))
                                   for k, v in head.items()}
    return C.StageSpec(params, config,
                       F.DATASET_FALLBACK_MEAN if mean is None else mean,
                       F.DATASET_FALLBACK_STD if std is None else std,
                       tuple(labels))


def _spec(spec):
    """A StageSpec, or the keyword arguments of `seeded_spec`."""
    return seeded_spec(**spec) if isinstance(spec, dict) else spec


def _launch_counts() -> dict:
    from ..ops import attention as A

    return {name: getattr(A, name).launches
            for name in ("mha_packed", "mha_pairs", "mha", "mha_qblock",
                         "mha_batched_heads", "mha_fused", "mha_packed_lse",
                         "mha_packed_bwd_dq", "mha_packed_bwd_dkdv")}


def _zero_counts() -> None:
    from ..ops import attention as A

    for name in _launch_counts():
        getattr(A, name).launches = 0


def engine_probs(stage1, stage2, audio: np.ndarray, config, device,
                 num_slices: int = 1, warmup: bool = False) -> dict:
    """`TwoStageEngine(..., mesh=data_mesh(num_slices=...))` over every
    rank: (p1, p2) of `window_probs(audio)` and each rank's kernel launches
    during that call (counts set to 0 just before it)."""
    from ..infer import cascade as C

    mesh = pmesh.data_mesh(num_slices=num_slices)
    engine = C.TwoStageEngine(_spec(stage1), _spec(stage2), config,
                              device=device, mesh=mesh)
    if warmup:
        engine.window_probs(audio)
    _zero_counts()
    p1, p2 = engine.window_probs(audio)
    mine = _launch_counts()
    return {"p1": p1, "p2": p2, "mesh_shape": tuple(mesh.mesh.shape),
            "launches": pmesh.all_gather_objects(mine)}


def make_loss(name: str, **kw):
    """A loss(logits, labels) by name: "stage1" (`stage1_loss`), "focal"
    (`stage2_focal_loss`) or "wce" (`stage2_weighted_ce`), with its
    keyword arguments."""
    from ..train import losses

    fn = {"stage1": losses.stage1_loss, "focal": losses.stage2_focal_loss,
          "wce": losses.stage2_weighted_ce}[name]

    def loss(logits, labels):
        return fn(logits, labels, **kw)

    return loss


def _tree_numpy(tree) -> dict:
    from ..models import convert

    return convert.params_to_numpy(tree)


def _replicas_max_diff(leaves: list[torch.Tensor], mesh) -> float:
    """The largest |difference| between this rank's tensors and the mesh's
    first rank's, over every rank."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in leaves])
    first = flat.clone()
    pmesh.replicate(first, mesh)
    return max(pmesh.all_gather_objects(
        float((flat - first).abs().max()), mesh))


def train_step(params, config, feats: np.ndarray, labels: np.ndarray,
               loss: tuple, device, dtype=torch.float32,
               num_slices: int = 1, lr: float = 1e-3,
               attention_impl: str = "torch",
               with_params: bool = True) -> dict:
    """One data-parallel step over every rank (`steps.make_train_step(...,
    mesh=data_mesh(num_slices=...))`) from `params` (the port's tree, or
    `seeded_spec`'s keywords) on the global batch, `loss` (name, keyword
    arguments) as `make_loss` takes them: the loss, the gradients
    summed over the mesh (JAX layout, f32), the parameters after the
    update, how far any rank's parameters are from the first rank's, and
    each rank's kernel launches (the "kernel" attention route launches
    `mha_packed_trainable`'s kernels). `with_params=False` leaves the
    parameters out of the result (a full-width tree is 344 MB)."""
    from ..train import optim, steps

    if isinstance(params, dict) and "seed" in params:
        spec = seeded_spec(**params)
        params, config = spec.params, spec.config
    mesh = pmesh.data_mesh(num_slices=num_slices)
    params = optim.tree_map(lambda t: t.detach().to(device), params)
    pmesh.replicate(params, mesh)
    tx = optim.make_optimizer(lr, 10, 0.1, 0.01)
    opt_state = tx.init(params)
    loss_fn = make_loss(loss[0], **(loss[1] if len(loss) > 1 else {}))

    vg = steps.make_value_and_grad(config, loss_fn, dtype=dtype, mesh=mesh,
                                   attention_impl=attention_impl)
    f = torch.from_numpy(feats)
    y = torch.from_numpy(labels).to(device)
    _zero_counts()
    (loss_val, logits), grads = vg(params, f, y)
    launches = _launch_counts()
    updates, opt_state = tx.update(grads, opt_state, params)
    new_params = optim.apply_updates(params, updates)
    leaves = [t for _, t in optim.tree_items(new_params)]
    out = {"loss": float(loss_val), "logits": logits.cpu().numpy(),
           "grads": _tree_numpy(optim.tree_map(lambda t: t.cpu(), grads)),
           "replica_diff": _replicas_max_diff(leaves, mesh),
           "mesh_shape": tuple(mesh.mesh.shape),
           "launches": pmesh.all_gather_objects(launches)}
    if with_params:
        out["params"] = _tree_numpy(optim.tree_map(lambda t: t.cpu(),
                                                   new_params))
    return out


def stacked_step(params, config, feats: np.ndarray, labels: np.ndarray,
                 mask: np.ndarray, device, class_weights=None,
                 lr: float = 1e-3) -> dict:
    """One fold-parallel step (`fold_parallel.make_stacked_train_step`)
    of F folds from the same `params`, each fold's batch rows (feats (F, B,
    ...)) sharded over every rank as one fold group's "data" mesh: the
    per-fold losses and each fold's parameters after the update."""
    from ..train import fold_parallel, optim

    mesh = pmesh.data_mesh()
    F = feats.shape[0]
    stacked = fold_parallel.stack(params, F, torch.device(device))
    opt_state = torch.func.vmap(optim.adamw_init)(stacked)
    cw = torch.as_tensor(np.ones((F, 2), np.float32) if class_weights is None
                         else class_weights, device=device)

    def loss(logits, y, m, hp):
        from ..train import losses

        return losses.stage2_focal_loss(logits, y, hp["class_w"],
                                        sample_mask=m)

    step = fold_parallel.make_stacked_train_step(
        config, loss, optim.decay_mask(params), dtype=torch.float32,
        weight_decay=0.01, beta2=0.98, mesh=mesh)
    hp = {"lr": torch.full((F,), lr, device=device), "class_w": cw}
    new, _, per = step(stacked, opt_state, torch.from_numpy(feats),
                       torch.from_numpy(labels).to(device),
                       torch.from_numpy(mask).to(device),
                       torch.ones(F, dtype=torch.bool, device=device), hp)
    leaves = [t for _, t in optim.tree_items(new)]
    return {"losses": per.cpu().numpy(),
            "params": [_tree_numpy(fold_parallel.member(new, f))
                       for f in range(F)],
            "replica_diff": _replicas_max_diff(leaves, mesh)}


def _use_init(init) -> None:
    """With init = (a JAX-layout numpy tree, the port's ASTConfig), every
    `loop.init_model` of this rank returns those parameters: the caller
    holds the ranks to a run of the JAX package from the same tree (the
    JAX PRNGKey stream cannot be drawn here)."""
    if init is None:
        return
    from ..models import convert
    from ..train import loop

    tree, config = init
    loop.init_model = lambda cfg: (convert.params_from_jax(tree), config)


def train_fold(fold: int, cfg, init=None) -> list:
    """`loop.train_fold(fold, cfg)` in every rank; every rank's metrics."""
    from ..train import loop

    _use_init(init)
    return pmesh.all_gather_objects(loop.train_fold(fold, cfg))


def train_folds_parallel(folds: list, cfg, init=None) -> list:
    """`fold_parallel.train_folds_parallel` in every rank; every rank's
    per-fold metrics."""
    from ..train import fold_parallel

    _use_init(init)
    return pmesh.all_gather_objects(
        fold_parallel.train_folds_parallel(folds, cfg))


def train_trials_parallel(fold: int, cfgs: list, init=None, **kw) -> list:
    """`trial_parallel.train_trials_parallel` in every rank; every rank's
    per-trial metrics."""
    from ..train import trial_parallel

    _use_init(init)
    return pmesh.all_gather_objects(
        trial_parallel.train_trials_parallel(fold, cfgs, **kw))


def make_mesh_error(*args, **kw) -> str:
    """The ValueError message of `make_mesh(*args, **kw)` in a rank, or ""
    when it builds a mesh."""
    try:
        pmesh.make_mesh(*args, **kw)
    except ValueError as e:
        return str(e)
    return ""


def mesh_layout(num_slices: int = 1, data_per_fold: int | None = None,
                n: int = 16) -> dict:
    """Each rank's view of a mesh over the process group: shape, axis
    names, its position, the ranks of its "data" sub-mesh, and over the
    mesh it shards on (a fold group's with `data_per_fold`)
    `local_batch_size(n)`, its `shard_batch` of arange(n), the
    `gather_rows` round trip and a `replicate`d tensor."""
    if data_per_fold:
        mesh = pmesh.fold_data_mesh(pmesh.world_size(), data_per_fold,
                                    device="cpu")
        sub = mesh[pmesh.DATA_AXIS]
    else:
        mesh = sub = pmesh.data_mesh(num_slices=num_slices)
    x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    local = pmesh.shard_batch(x, sub)
    t = torch.full((2,), float(pmesh.rank()))
    pmesh.replicate(t, sub)
    mine = {"rank": pmesh.rank(), "shape": tuple(mesh.mesh.shape),
            "names": tuple(mesh.mesh_dim_names),
            "mesh_rank": pmesh.mesh_rank(mesh),
            "sub_ranks": pmesh.mesh_ranks(sub),
            "data_ranks": pmesh.mesh_ranks(
                mesh[pmesh.DATA_AXIS] if mesh.mesh.dim() > 1 else mesh),
            "local_batch": pmesh.local_batch_size(n, sub),
            "shard": local.numpy(),
            "gathered": pmesh.gather_rows(local, sub).numpy(),
            "replicated": t.tolist()}
    return pmesh.all_gather_objects(mine)



def sequence(calls: list) -> list:
    """Run (function name of this module, args, kwargs) calls in turn, in
    every rank: one process group serves several checks. Each entry of the
    result is ("ok", the call's result) or ("error", "Type: message"); an
    error in one rank is every rank's (the calls see the same inputs)."""
    out = []
    for name, args, kwargs in calls:
        try:
            out.append(("ok", globals()[name](*args, **kwargs)))
        except (ValueError, RuntimeError) as e:
            out.append(("error", f"{type(e).__name__}: {e}"))
    return out
