"""Fold-parallel cross-validation training: all folds in one vmapped step.

The port of the JAX package's `train/fold_parallel.py`, on one device. The
reference trains its 5 CV folds one after another; here every fold runs
the same program on its own data and its own weights, so the whole CV run
is one step over stacked per-fold state:

    forward: the model's own pieces (`models.ast.embed`, `_block`,
             `final_norm`, `pool`, `classify`) under `torch.func.vmap`
             over the fold axis, each vmapped block under
             `torch.utils.checkpoint` (remat outside the vmap: a
             checkpoint inside a vmapped function is refused);
    loss:    the per-fold loss vmapped, summed over folds, and one
             ordinary autograd backward (inside `full_f32()`, as
             `train.steps.value_and_grad`); fold f's parameters get fold
             f's gradient only;
    update:  `optim.adamw_apply` vmapped over folds, so the global-norm
             clip is each fold's own (a norm over all folds would couple
             them once one fold's norm passes 1.0).

Folds never exchange a value, so each fold's numerics are the sequential
trainer's (train/loop.py:train_fold):

  * per-fold LR schedule: folds differ in train-set size, hence in total
    steps and warmup. The update takes each fold's scheduled learning rate
    as a tensor, from the same HF-linear formula (`_lr_factor`).
  * unequal batch counts: the step loop runs to the largest fold's
    steps_per_epoch; a fold past its own count, or one that has stopped
    early, takes a masked no-op step (`torch.where(active, new, old)` on
    its parameters and every optimizer leaf, the Adam count included), so
    its schedule position stays exactly sequential.
  * tail batches: rows are padded to batch_size with a 0/1 sample mask;
    the losses' masked means equal the plain means the sequential path
    takes on the smaller tail batch.
  * per-fold early stopping, best-F1 selection and checkpoints go through
    the sequential loop's own helpers (`FoldProgress`, `epoch_bookkeeping`,
    `finalize_fold`); a fold's checkpoint is in the sequential layout
    (`loop.sequential_opt_layout`), so the sequential `--resume` of either
    package continues it.

The steps run the model's "torch" attention, as the sequential loop's do
(the Hopper kernels' autograd Function has no vmap rule). Not supported
here (use the sequential path): `streaming`, `grad_accum` > 1, `resume`,
`num_slices` and the `on_epoch_end` hook.

Over several devices (`num_devices`, parallel/mesh.py) the fold axis is
split over the ranks, as JAX shards it over its "fold" mesh axis: the
folds divide into `num_devices / data_per_fold` groups of consecutive
folds, and each group of ranks runs this trainer's vmapped step on its own
folds. With `data_per_fold` > 1 the ranks of a group also shard each
fold's batch rows and sum the gradients over the group's "data" sub-mesh
only (a 2-D ("fold", "data") mesh); no collective crosses groups but the
per-epoch check that every fold has stopped and the final gather of the
metrics. A group's first rank writes its folds' files.

`stacked_forward` and `make_stacked_train_step` also serve the
trial-parallel sweep (train/trial_parallel.py), whose members share one
batch.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import numpy as np
import torch
from torch.func import vmap

from ..infer.cascade import resolve_device
from ..parallel import mesh as pmesh
from ..parallel.mesh import FOLD_AXIS
from ..models import ast as ast_mod
from ..utils.precision import full_f32
from . import loop as L, losses, metrics as metrics_mod, optim, steps


@dataclasses.dataclass
class _FoldData:
    fold: int
    fold_dir: str
    mean: float
    std: float
    train_feats: np.ndarray
    train_y: np.ndarray
    test_feats: np.ndarray
    test_y: np.ndarray
    val_feats: np.ndarray | None
    val_y: np.ndarray | None
    class_weights: np.ndarray  # (2,); ones when unused
    steps_per_epoch: int
    total_steps: int
    warmup_steps: int

    @property
    def has_val(self) -> bool:
        return self.val_feats is not None

    @property
    def eval_feats(self) -> np.ndarray:
        return self.val_feats if self.has_val else self.test_feats

    @property
    def eval_y(self) -> np.ndarray:
        return self.val_y if self.has_val else self.test_y


def _prepare_fold(fold: int, cfg: L.TrainFoldConfig, model_cfg,
                  device: torch.device, mesh=None) -> _FoldData:
    """Per-fold data through the helpers shared with the sequential trainer
    (loop.prepare_fold_dir / load_fold_splits). The model's initialization
    is the same for every fold (same seed, same pretrained dir), so the
    caller makes it once."""
    fold_dir, mean, std = L.prepare_fold_dir(fold, cfg, mesh)
    train_x, train_y, test_x, test_y, val_x, val_y = L.load_fold_splits(
        fold, cfg)

    aug_rng = np.random.default_rng(cfg.seed) if cfg.augment else None
    mf = model_cfg.max_length
    train_feats = L.featurize_paths(train_x, mean, std, aug_rng,
                                    max_frames=mf, device=device)
    test_feats = L.featurize_paths(test_x, mean, std, max_frames=mf,
                                   device=device)
    val_feats = (L.featurize_paths(val_x, mean, std, max_frames=mf,
                                   device=device)
                 if val_x is not None else None)

    class_weights = np.ones(2, np.float32)
    if cfg.stage == "stage2" and cfg.use_class_weights:
        class_weights = losses.inverse_frequency_weights(train_y)
        print(f"[ClassWeights] fold {fold}: {class_weights}")

    n = len(train_feats)
    num_epochs = 1 if cfg.dry_run else cfg.num_epochs
    steps_per_epoch = -(-n // cfg.batch_size)
    total_steps = num_epochs * steps_per_epoch
    return _FoldData(
        fold=fold, fold_dir=fold_dir, mean=mean, std=std,
        train_feats=train_feats, train_y=np.asarray(train_y, np.int64),
        test_feats=test_feats, test_y=np.asarray(test_y, np.int64),
        val_feats=val_feats,
        val_y=(np.asarray(val_y, np.int64) if val_y is not None else None),
        class_weights=np.asarray(class_weights, np.float32),
        steps_per_epoch=steps_per_epoch, total_steps=total_steps,
        warmup_steps=math.ceil(total_steps * cfg.warmup_ratio))


def _make_parallel_loss(cfg: L.TrainFoldConfig):
    """loss(logits, labels, mask, hp) -> scalar, per fold: the vmapped
    counterpart of loop._make_loss, with the fold's class weights in
    hp["class_w"]."""
    if cfg.stage == "stage1":
        def loss(logits, labels, mask, hp):
            return losses.stage1_loss(logits, labels, cfg.focal_gamma,
                                      cfg.label_smoothing, sample_mask=mask)
    elif cfg.use_focal_loss:
        def loss(logits, labels, mask, hp):
            cw = hp["class_w"] if cfg.use_class_weights else None
            return losses.stage2_focal_loss(
                logits, labels, cw, cfg.focal_alpha, cfg.focal_gamma,
                cfg.label_smoothing, sample_mask=mask)
    else:
        def loss(logits, labels, mask, hp):
            cw = hp["class_w"] if cfg.use_class_weights else None
            return losses.stage2_weighted_ce(logits, labels, cw,
                                             cfg.label_smoothing,
                                             sample_mask=mask)
    return loss


def _lr_factor(step: torch.Tensor, total_steps: torch.Tensor,
               warmup_steps: torch.Tensor) -> torch.Tensor:
    """optim.linear_schedule's factor with (step, total, warmup) as f32
    tensors, one per fold or trial."""
    warm = step / torch.clamp(warmup_steps, min=1.0)
    decay = (total_steps - step) / torch.clamp(total_steps - warmup_steps,
                                               min=1.0)
    return torch.clamp(torch.where(step < warmup_steps, warm, decay),
                       0.0, 1.0)


def stack(tree, n: int, device: torch.device):
    """n copies of every leaf of `tree` along a new leading axis, on
    `device`."""
    return optim.tree_map(
        lambda t: t.detach().to(device).unsqueeze(0).repeat(
            n, *([1] * t.dim())), tree)


def member(tree, i: int):
    """Host copy of member i of a stacked tree."""
    return optim.tree_map(lambda t: t[i].detach().cpu(), tree)


def stacked_forward(params, feats: torch.Tensor, model_cfg, *, dtype,
                    remat: bool = False,
                    shared_batch: bool = False) -> torch.Tensor:
    """f32 logits (N, B, num_labels) of N stacked parameter trees (every
    leaf with a leading N). feats: (N, B, frames, mels), one batch per
    member, or (B, frames, mels) shared by all (`shared_batch`).

    The model's own pieces under `torch.func.vmap`. With `remat` (and
    autograd recording) each vmapped block runs under
    `torch.utils.checkpoint`, as `models.ast.encode(remat=True)` runs each
    block: only the (N, B, S, H) block inputs are kept for the backward."""
    block = vmap(functools.partial(ast_mod._block, config=model_cfg,
                                   impl="torch"))
    if remat and torch.is_grad_enabled():
        block = ast_mod._checkpointed(block, "full")

    def head(p, hidden):
        hidden = ast_mod.final_norm(p, hidden, model_cfg)
        return ast_mod.classify(p, ast_mod.pool(hidden), model_cfg)

    with full_f32():
        x = vmap(functools.partial(ast_mod.embed, config=model_cfg,
                                   dtype=dtype),
                 in_dims=(0, None if shared_batch else 0))(params, feats)
        enc = params["encoder"]
        for layer in range(enc["ln1"]["scale"].shape[1]):
            lp = {name: {key: leaf[:, layer] for key, leaf in group.items()}
                  for name, group in enc.items()}
            x = block(x, lp)
        return vmap(head)(params, x)


def make_stacked_train_step(model_cfg, loss_fn: Callable, mask_tree, *,
                            dtype, shared_batch: bool = False,
                            weight_decay: float | None = None,
                            beta2: float | None = None, mesh=None):
    """step(params, opt_state, feats, labels, row_mask, active, hp) ->
    (params', opt_state', losses (N,)): one AdamW update of every member.

    params and opt_state (`optim.adamw_init`'s, stacked) have a leading N;
    feats, labels and row_mask have one too unless `shared_batch`; active
    is (N,) bool; hp is a dict of (N, ...) tensors: "lr" (the scheduled
    step size), "wd" and "b2" unless weight_decay / beta2 are given here,
    and whatever loss_fn(logits, labels, row_mask, hp) reads, per member.
    An inactive member's parameters and state come back as they went in.

    `mesh` (a 1-D "data" mesh): every rank passes the global batch (feats
    may stay on the host) and runs its contiguous share of the rows; the
    members' losses are the global batch's and each member's gradient is
    summed over the mesh (train/steps.py:sharded_value_and_grad)."""
    data_dim = None if shared_batch else 0
    member_loss = vmap(loss_fn, in_dims=(0, data_dim, data_dim, 0))

    def member_update(p, st, g, active, hp):
        new_p, new_st = optim.adamw_apply(
            p, st, g, lr=hp["lr"],
            weight_decay=hp["wd"] if weight_decay is None else weight_decay,
            beta2=hp["b2"] if beta2 is None else beta2, mask_tree=mask_tree)

        def keep(new, old):
            return optim.tree_map(lambda a, b: torch.where(active, a, b),
                                  new, old)
        return keep(new_p, p), keep(new_st, st)

    update = vmap(member_update)

    def objective(p, feats, labels, row_mask, hp):
        logits = stacked_forward(p, feats, model_cfg, dtype=dtype,
                                 remat=True, shared_batch=shared_batch)
        per = member_loss(logits, labels, row_mask, hp)
        # the members are independent: d(sum)/d(member i's leaves) is
        # member i's own gradient
        return per.sum(), per

    def forward(p, feats):
        return stacked_forward(p, feats, model_cfg, dtype=dtype, remat=True,
                               shared_batch=shared_batch)

    def on_logits(logits, labels, row_mask, hp):
        per = member_loss(logits, labels, row_mask, hp)
        return per.sum(), per

    def step(params, opt_state, feats, labels, row_mask, active, hp):
        if mesh is not None:
            local = pmesh.local_rows(feats, mesh,
                                     0 if shared_batch else 1).to(
                labels.device)
            (_, per), grads = steps.sharded_value_and_grad(
                forward, on_logits, params, (local,),
                (labels, row_mask, hp), mesh, dim=1)
        else:
            (_, per), grads = steps.value_and_grad(
                objective, params, feats.to(labels.device), labels,
                row_mask, hp)
        new_params, new_opt = update(params, opt_state, grads, active, hp)
        return new_params, new_opt, per

    return step


def stacked_eval_logits(params, chunk: np.ndarray, model_cfg, dtype,
                        device: torch.device, shared_batch: bool = False,
                        mesh=None) -> np.ndarray:
    """stacked_forward's logits (N, B, labels) of one host chunk, without
    autograd; with `mesh` each rank runs its share of the rows and the
    logits are gathered."""
    with torch.no_grad():
        if mesh is None:
            feats = torch.from_numpy(chunk).to(device)
        else:
            feats = pmesh.shard_batch(chunk, mesh, 0 if shared_batch else 1,
                                      device)
        logits = stacked_forward(params, feats, model_cfg, dtype=dtype,
                                 shared_batch=shared_batch)
        if mesh is not None:
            logits = pmesh.gather_rows(logits, mesh, 1)
    return logits.cpu().numpy()


def _stacked_eval(params, folds_data: list[_FoldData], model_cfg, dtype,
                  batch: int, device: torch.device,
                  mesh=None) -> list[np.ndarray]:
    """Per-fold logits over each fold's eval split (val, or test when no
    val exists), evaluated fold-parallel on zero-padded stacks; returns the
    valid prefixes."""
    sets = [fd.eval_feats for fd in folds_data]
    n_max = max(len(s) for s in sets)
    outs = [[] for _ in sets]
    for s in range(0, n_max, batch):
        chunk = np.zeros((len(sets), batch) + sets[0].shape[1:],
                         sets[0].dtype)
        for f, data in enumerate(sets):
            rows = data[s: s + batch]
            chunk[f, : len(rows)] = rows
        logits = stacked_eval_logits(params, chunk, model_cfg, dtype, device,
                                     mesh=mesh)
        for f, data in enumerate(sets):
            k = min(batch, max(0, len(data) - s))
            if k:
                outs[f].append(logits[f, :k])
    return [np.concatenate(o) if o else np.zeros((0, 2), np.float32)
            for o in outs]


@L._deterministic_cudnn()
def train_folds_parallel(folds: list[int], cfg: L.TrainFoldConfig,
                         trackers: dict[int, Any] | None = None
                         ) -> list[dict[str, float]]:
    """Train all `folds` at once in one vmapped step (module docstring) on
    cfg.device; returns the per-fold metrics dicts of sequential
    train_fold calls and writes the same artifacts (checkpoints, best/
    export, evaluation dirs, history.json)."""
    if cfg.streaming:
        raise ValueError("fold-parallel training requires eager "
                         "featurization (drop --streaming)")
    if cfg.grad_accum > 1:
        raise ValueError("fold-parallel training does not implement "
                         "gradient accumulation")
    if cfg.resume:
        raise ValueError("fold-parallel training does not support --resume; "
                         "resume individual folds with the sequential path")
    if cfg.num_slices and cfg.num_slices > 1:
        raise ValueError("fold-parallel training shards the fold axis over "
                         "a flat mesh; --num-slices is not supported here")
    if cfg.on_epoch_end is not None:
        raise ValueError("fold-parallel training does not support the "
                         "on_epoch_end hook (sweep trials cut per trial; "
                         "use the sequential path)")
    data_per_fold = cfg.data_per_fold or 1
    if data_per_fold > 1 and not (cfg.num_devices and cfg.num_devices > 1):
        raise ValueError("data_per_fold > 1 requires num_devices > 1")
    if cfg.num_devices and cfg.num_devices > 1:
        # validate before run dirs are backed up or data is featurized
        cfg = _validate_groups(folds, cfg, data_per_fold, "fold")
    device = resolve_device(cfg.device)
    trackers = trackers or {}
    print(f"\n===== {cfg.stage} folds {list(folds)} (fold-parallel) =====")

    all_folds = list(folds)
    mesh, data_mesh, folds = _group_share(all_folds, cfg, data_per_fold,
                                          FOLD_AXIS, "folds")

    # one initialization for every fold, as each sequential train_fold call
    # would make it
    params0, model_cfg = L.init_model(cfg)
    folds_data = [_prepare_fold(f, cfg, model_cfg, device, data_mesh)
                  for f in folds]
    F = len(folds_data)
    bs = cfg.batch_size
    num_epochs = 1 if cfg.dry_run else cfg.num_epochs
    max_steps = max(fd.steps_per_epoch for fd in folds_data)
    checkpoint_limit = 1 if cfg.dry_run else max(2, (cfg.num_epochs + 1) // 2)

    params = stack(params0, F, device)
    opt_state = vmap(optim.adamw_init)(params)
    train_step = make_stacked_train_step(
        model_cfg, _make_parallel_loss(cfg), optim.decay_mask(params0),
        dtype=cfg.dtype, weight_decay=cfg.weight_decay, beta2=cfg.adam_beta2,
        mesh=data_mesh)

    def per_fold(values, dtype=torch.float32):
        return torch.as_tensor(np.asarray(values), dtype=dtype, device=device)

    total = per_fold([fd.total_steps for fd in folds_data])
    warmup = per_fold([fd.warmup_steps for fd in folds_data])
    class_w = per_fold(np.stack([fd.class_weights for fd in folds_data]))

    # host-side per-fold loop state (loop.FoldProgress, shared bookkeeping)
    epoch_rngs = [np.random.default_rng(cfg.seed) for _ in folds_data]
    progs = [L.FoldProgress(patience_left=cfg.early_stopping_patience)
             for _ in folds_data]

    feat_shape = folds_data[0].train_feats.shape[1:]
    for epoch in range(1, num_epochs + 1):
        orders = [rng.permutation(len(fd.train_feats))
                  if not progs[f].stopped else None
                  for f, (rng, fd) in enumerate(zip(epoch_rngs, folds_data))]
        epoch_loss = np.zeros(F)
        for s_idx in range(max_steps):
            feats = np.zeros((F, bs) + feat_shape, np.float32)
            labels = np.zeros((F, bs), np.int64)
            mask = np.zeros((F, bs), np.float32)
            active = np.zeros(F, bool)
            step_idx = np.zeros(F, np.float32)
            counts = np.zeros(F, int)
            for f, fd in enumerate(folds_data):
                if progs[f].stopped or s_idx >= fd.steps_per_epoch:
                    continue
                idx = orders[f][s_idx * bs: (s_idx + 1) * bs]
                feats[f, : len(idx)] = fd.train_feats[idx]
                labels[f, : len(idx)] = fd.train_y[idx]
                mask[f, : len(idx)] = 1.0
                active[f] = True
                counts[f] = len(idx)
                step_idx[f] = (epoch - 1) * fd.steps_per_epoch + s_idx
            if not active.any():
                continue
            lr = cfg.learning_rate * _lr_factor(per_fold(step_idx), total,
                                                warmup)
            params, opt_state, loss_vals = train_step(
                params, opt_state,
                per_fold(feats) if data_mesh is None
                else torch.from_numpy(feats),
                per_fold(labels, torch.int64),
                per_fold(mask), per_fold(active, torch.bool),
                {"lr": lr, "class_w": class_w})
            loss_np = loss_vals.cpu().numpy()
            epoch_loss += np.where(active, loss_np * counts, 0.0)
            if cfg.logging_steps and trackers:
                # the reference's per-step loss channel (HF logging_steps),
                # the sequential trainer's payload
                for f, fd in enumerate(folds_data):
                    tr = trackers.get(fd.fold)
                    gstep = int(step_idx[f]) + 1
                    if (tr is not None and active[f]
                            and gstep % cfg.logging_steps == 0):
                        tr.log({"fold": fd.fold, "train_step": gstep,
                                "train_step_loss": float(loss_np[f])})

        eval_logits = _stacked_eval(params, folds_data, model_cfg, cfg.dtype,
                                    cfg.eval_batch_size, device, data_mesh)
        for f, fd in enumerate(folds_data):
            prog = progs[f]
            if prog.stopped:
                continue
            m = metrics_mod.compute_metrics_from_logits(eval_logits[f],
                                                        fd.eval_y)
            m["loss"] = float(epoch_loss[f] / len(fd.train_feats))
            prog.history.append({"epoch": epoch, **m})
            print(f"[Fold {fd.fold} Epoch {epoch}/{num_epochs}] "
                  f"loss={m['loss']:.4f} eval_f1={m['f1']:.4f} "
                  f"acc={m['accuracy']:.4f}")
            tr = trackers.get(fd.fold)
            if tr is not None:
                tr.log({"fold": fd.fold, "epoch": epoch,
                        **{f"eval_{k}" if k != "loss" else "train_loss": v
                           for k, v in m.items()}})

            L.epoch_bookkeeping(
                cfg, fd.fold_dir, epoch, fd.steps_per_epoch,
                checkpoint_limit, m, fd.has_val, prog,
                snapshot=lambda f=f: (
                    member(params, f),
                    L.sequential_opt_layout(member(opt_state, f))),
                rng_state=epoch_rngs[f].bit_generator.state,
                label=f" fold {fd.fold}:", mesh=data_mesh)
        if _all_stopped(progs, mesh):
            break

    # each fold's best export, metrics and CM artifacts through the
    # sequential trainer's helper
    all_metrics = []
    single_eval = steps.make_eval_step(model_cfg, dtype=cfg.dtype,
                                       mesh=data_mesh, device=device)
    for f, fd in enumerate(folds_data):
        prog = progs[f]
        if prog.best_params is None:
            prog.best_params = member(params, f)
        all_metrics.append(L.finalize_fold(
            fd.fold, cfg, fd.fold_dir, model_cfg, fd.mean, fd.std,
            prog.best_params, prog.best_epoch, prog.best_f1, fd.eval_feats,
            fd.eval_y, fd.has_val, fd.test_feats, fd.test_y, single_eval,
            device, trackers.get(fd.fold), prog.history,
            class_weights=(fd.class_weights if cfg.use_class_weights
                           else None), mesh=data_mesh))
    return _gather_groups(all_metrics, mesh, data_per_fold)


def _validate_groups(members: list, cfg: L.TrainFoldConfig, per_group: int,
                     what: str) -> L.TrainFoldConfig:
    """JAX's checks of a fold (trial) axis over `cfg.num_devices` devices
    in groups of `per_group`; returns cfg with eval_batch_size rounded up
    to a group multiple."""
    n_dev = cfg.num_devices
    groups = n_dev // per_group
    if n_dev % per_group:
        raise ValueError(f"{n_dev} devices not divisible into groups of "
                         f"{per_group}")
    if len(members) % groups:
        raise ValueError(f"{len(members)} {what}s not divisible by {groups} "
                         f"{what} groups ({n_dev} devices / {per_group} per "
                         f"{what})")
    if per_group > 1 and cfg.batch_size % per_group:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by "
                         f"data_per_{what} {per_group}")
    if per_group > 1 and cfg.eval_batch_size % per_group:
        # eval_batch_size is not CLI-exposed: round up instead of erroring
        # (the eval chunk size only affects speed)
        bumped = -(-cfg.eval_batch_size // per_group) * per_group
        print(f"[Mesh] eval_batch_size {cfg.eval_batch_size} -> {bumped} "
              f"(rounded up to a {per_group}-device group multiple)")
        cfg = dataclasses.replace(cfg, eval_batch_size=bumped)
    return cfg


def _group_share(members: list, cfg: L.TrainFoldConfig, per_group: int,
                 axis_name: str, what: str):
    """(mesh, the group's "data" sub-mesh or None, this rank's members):
    the members split into consecutive equal shares, one per group of
    `per_group` ranks, as JAX shards the axis over the mesh."""
    if per_group > 1:
        mesh = pmesh.fold_data_mesh(cfg.num_devices, per_group, axis_name,
                                    device=cfg.device)
    else:
        mesh = pmesh.make_mesh(cfg.num_devices, axis_name=axis_name,
                               device=cfg.device)
    if mesh is None:
        return None, None, members
    groups = mesh.mesh.shape[0]
    share = len(members) // groups
    g = pmesh.mesh_rank(mesh) // per_group
    if per_group > 1:
        print(f"[Mesh] {len(members)} {what} over {pmesh.mesh_size(mesh)} "
              f"devices: {groups} {axis_name} groups x {per_group} "
              f"data-parallel devices each")
    else:
        print(f"[Mesh] {len(members)} {what} over {pmesh.mesh_size(mesh)} "
              f"devices (axis '{axis_name}')")
    return (mesh, mesh[pmesh.DATA_AXIS] if per_group > 1 else None,
            members[g * share: (g + 1) * share])


def _all_stopped(progs, mesh) -> bool:
    """Whether every member has stopped, on every group of the mesh (each
    group then leaves its epoch loop at the same epoch)."""
    mine = all(p.stopped for p in progs)
    if mesh is None:
        return mine
    return all(pmesh.all_gather_objects(mine, mesh))


def _gather_groups(results: list, mesh, per_group: int) -> list:
    """Every group's results, in group order, on every rank."""
    if mesh is None:
        return results
    every = pmesh.all_gather_objects(results, mesh)
    return [r for group in every[::per_group] for r in group]
