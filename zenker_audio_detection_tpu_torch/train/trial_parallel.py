"""Trial-parallel hyperparameter sweeps: N trials in one vmapped step.

The port of the JAX package's `train/trial_parallel.py`, on one device.
Sweep trials all train on the SAME fold, with the same clips, the same
featurization and the same batch order (each sequential trial reseeds
`default_rng(cfg.seed)`), so the stacked run shares ONE batch per step
across the trials:

    vmap(trial_step, in_dims=(0, 0, 0, 0, None, None, None, None))

with only (params, optimizer state, hyperparameters, active) per trial.
The step is fold_parallel's `make_stacked_train_step` with a shared batch:
the model's pieces vmapped over trials (each block under
`torch.utils.checkpoint`), the per-trial losses vmapped and summed, one
autograd backward, and `optim.adamw_apply` vmapped over trials.

The six swept hyperparameters (`SWEPT_FIELDS`) are tensors in the step:
  * learning rate and warmup_ratio: the HF-linear factor from the shared
    step index and per-trial (total, warmup), times the trial's lr;
  * weight_decay and adam_beta2: `optim.adamw_apply`'s tensor arguments;
  * focal_gamma and label_smoothing: the `losses.*_traced` forms, equal to
    the branchy sequential losses at every point, γ=0 and ls=0 included.

Hyperband rung cuts differ from the sequential agent by construction: all
trials reach a rung together, so the cut is the true Hyperband rule (drop
the trials on the wrong side of the median of ALL trials at the rung), not
the sequential agent's streaming median. A cut trial takes masked no-op
steps for the rest of the run.

The fold-parallel trainer's restrictions hold (eager featurization, no
resume, no grad accumulation, no `num_slices`); every trial must share
everything but the six swept fields and its output root.

Over several devices (`num_devices`) the trial axis is split over groups
of ranks as fold_parallel splits folds: `data_per_fold` (the CLI's
`--data-per-trial`) ranks per group share each batch's rows and sum the
gradients over the group's "data" sub-mesh. The Hyperband median at a
rung is taken over every group's trials (one gather per epoch), as JAX
takes it over the whole trial axis.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch.func import vmap

from ..infer.cascade import resolve_device
from . import loop as L, losses, metrics as metrics_mod, optim, steps
from .fold_parallel import (_all_stopped, _gather_groups, _group_share,
                            _lr_factor, _validate_groups,
                            make_stacked_train_step, member, stack,
                            stacked_eval_logits)

TRIAL_AXIS = "trial"

# the swept hyperparameters (the reference's sweep YAML spaces); everything
# else must be the same in every stacked trial
SWEPT_FIELDS = ("learning_rate", "weight_decay", "adam_beta2",
                "warmup_ratio", "focal_gamma", "label_smoothing")
_SHARED_FIELDS = (
    "stage", "data_dir", "pretrained_model_dir", "num_epochs", "batch_size",
    "eval_batch_size", "dry_run", "enable_early_stopping",
    "early_stopping_patience", "early_stopping_threshold", "augment",
    "seed", "dtype", "device", "use_class_weights", "use_focal_loss",
    "focal_alpha", "max_length", "streaming", "resume", "num_devices",
    "num_slices", "data_per_fold", "grad_accum")


def _make_trial_loss(cfg: L.TrainFoldConfig, class_weights):
    """loss(logits, labels, mask, hp) with the trial's (gamma, ls) tensors
    in hp; class_weights and focal_alpha are shared (not swept)."""
    if cfg.stage == "stage1":
        def loss(logits, labels, mask, hp):
            return losses.stage1_loss_traced(logits, labels, hp["gamma"],
                                             hp["ls"], sample_mask=mask)
    elif cfg.use_focal_loss:
        def loss(logits, labels, mask, hp):
            return losses.stage2_focal_loss_traced(
                logits, labels, class_weights, cfg.focal_alpha, hp["gamma"],
                hp["ls"], sample_mask=mask)
    else:
        def loss(logits, labels, mask, hp):
            return losses.stage2_weighted_ce_traced(
                logits, labels, class_weights, hp["ls"], sample_mask=mask)
    return loss


def _check_configs(cfgs: list[L.TrainFoldConfig]) -> None:
    base = cfgs[0]
    for cfg in cfgs[1:]:
        for f in _SHARED_FIELDS:
            if getattr(cfg, f) != getattr(base, f):
                raise ValueError(
                    f"trial configs must agree on {f!r} "
                    f"({getattr(cfg, f)!r} != {getattr(base, f)!r}); only "
                    f"{SWEPT_FIELDS} and output_root may vary")
    if base.streaming:
        raise ValueError("trial-parallel sweeps require eager featurization "
                         "(drop --streaming)")
    if base.grad_accum > 1:
        raise ValueError("trial-parallel sweeps do not implement gradient "
                         "accumulation (trials share one data batch per "
                         "step); scale data via data_per_fold groups")
    if base.resume:
        raise ValueError("trial-parallel sweeps do not support --resume")
    if base.num_slices and base.num_slices > 1:
        raise ValueError("trial-parallel sweeps shard the trial axis over "
                         "a flat mesh; --num-slices is not supported here")
    if any(cfg.on_epoch_end is not None for cfg in cfgs):
        raise ValueError("on_epoch_end is not supported in trial-parallel "
                         "mode (Hyperband cuts run via `rungs`)")
    roots = [cfg.output_root for cfg in cfgs]
    if len(set(roots)) != len(roots):
        raise ValueError("trial configs must have distinct output_root "
                         "dirs (colliding trials would overwrite each "
                         "other's run artifacts)")


@L._deterministic_cudnn()
def train_trials_parallel(fold: int, cfgs: list[L.TrainFoldConfig], *,
                          rungs: list[int] | None = None,
                          goal: str = "maximize",
                          rung_metric: str = "f1") -> list[dict]:
    """Train all trial configs at once on one fold, on their (shared)
    device; returns per-trial metrics dicts like sequential `train_fold`
    calls (and writes the same per-trial run dirs). `rungs`: Hyperband rung
    epochs: at each, the trials whose per-epoch `rung_metric` is on the
    wrong side of the surviving trials' median (per `goal`) are cut
    (masked no-ops for the rest of the run)."""
    _check_configs(cfgs)
    base = cfgs[0]
    data_per_trial = base.data_per_fold or 1
    if data_per_trial > 1 and not (base.num_devices
                                   and base.num_devices > 1):
        raise ValueError("data_per_fold > 1 requires num_devices > 1")
    if base.num_devices and base.num_devices > 1:
        # validate before run dirs are backed up or data is featurized
        base = _validate_groups(cfgs, base, data_per_trial, "trial")
        cfgs = [dataclasses.replace(c, eval_batch_size=base.eval_batch_size)
                for c in cfgs]
    device = resolve_device(base.device)
    print(f"\n===== {base.stage} fold {fold}: {len(cfgs)} trials "
          f"(trial-parallel) =====")
    mesh, data_mesh, mine = _group_share(list(range(len(cfgs))), base,
                                         data_per_trial, TRIAL_AXIS,
                                         "trials")
    all_cfgs = cfgs
    cfgs = [all_cfgs[t] for t in mine]
    T = len(cfgs)

    params0, model_cfg = L.init_model(base)
    # every trial shares data_dir, so the fold statistics are one value;
    # prepare_fold_dir still runs per trial for its run-dir backup
    fold_dirs = []
    mean = std = None
    for cfg in cfgs:
        fd, mean, std = L.prepare_fold_dir(fold, cfg, data_mesh)
        fold_dirs.append(fd)

    # one dataset: every trial sees the fold with the same featurization
    # seed, as each sequential trial would
    train_x, train_y, test_x, test_y, val_x, val_y = L.load_fold_splits(
        fold, base)
    aug_rng = np.random.default_rng(base.seed) if base.augment else None
    mf = model_cfg.max_length
    train_feats = L.featurize_paths(train_x, mean, std, aug_rng,
                                    max_frames=mf, device=device)
    test_feats = L.featurize_paths(test_x, mean, std, max_frames=mf,
                                   device=device)
    val_feats = (L.featurize_paths(val_x, mean, std, max_frames=mf,
                                   device=device)
                 if val_x is not None else None)
    has_val = val_feats is not None
    eval_feats = val_feats if has_val else test_feats
    eval_y = np.asarray(val_y if has_val else test_y, np.int64)
    train_y = np.asarray(train_y, np.int64)

    class_weights = None
    if base.stage == "stage2" and base.use_class_weights:
        class_weights = losses.inverse_frequency_weights(train_y)
        print(f"[ClassWeights] {class_weights}")

    n = len(train_feats)
    bs = base.batch_size
    num_epochs = 1 if base.dry_run else base.num_epochs
    steps_per_epoch = -(-n // bs)
    total_steps = num_epochs * steps_per_epoch
    checkpoint_limit = (1 if base.dry_run
                        else max(2, (base.num_epochs + 1) // 2))

    params = stack(params0, T, device)
    opt_state = vmap(optim.adamw_init)(params)
    cw = (None if class_weights is None
          else torch.as_tensor(class_weights, device=device))
    train_step = make_stacked_train_step(
        model_cfg, _make_trial_loss(base, cw), optim.decay_mask(params0),
        dtype=base.dtype, shared_batch=True, mesh=data_mesh)

    def per_trial(values):
        return torch.as_tensor(np.asarray(values, np.float32), device=device)

    hp = {"wd": per_trial([c.weight_decay for c in cfgs]),
          "b2": per_trial([c.adam_beta2 for c in cfgs]),
          "gamma": per_trial([c.focal_gamma for c in cfgs]),
          "ls": per_trial([c.label_smoothing for c in cfgs])}
    lr_base = per_trial([c.learning_rate for c in cfgs])
    warm = per_trial([math.ceil(total_steps * c.warmup_ratio) for c in cfgs])
    total = per_trial([total_steps] * T)

    # host-side per-trial loop state (train_fold's locals, per trial)
    epoch_rng = np.random.default_rng(base.seed)  # shared: same batch order
    progs = [L.FoldProgress(patience_left=base.early_stopping_patience)
             for _ in range(T)]
    cut_at_rung: list[int | None] = [None] * T
    rungs = sorted(rungs or [])

    for epoch in range(1, num_epochs + 1):
        order = epoch_rng.permutation(n)
        epoch_loss = np.zeros(T)
        active = torch.as_tensor([not p.stopped for p in progs],
                                 device=device)
        for s_idx in range(steps_per_epoch):
            idx = order[s_idx * bs: (s_idx + 1) * bs]
            feats = train_feats[idx]
            labels = train_y[idx]
            row_mask = np.ones(len(idx), np.float32)
            if len(idx) < bs:  # pad the tail batch, mask the dummy rows
                pad = bs - len(idx)
                feats = np.concatenate(
                    [feats, np.zeros((pad,) + feats.shape[1:], feats.dtype)])
                labels = np.concatenate([labels, np.zeros(pad, np.int64)])
                row_mask = np.concatenate([row_mask,
                                           np.zeros(pad, np.float32)])
            step_idx = per_trial([(epoch - 1) * steps_per_epoch + s_idx] * T)
            hp["lr"] = lr_base * _lr_factor(step_idx, total, warm)
            feats = torch.from_numpy(feats)
            params, opt_state, loss_vals = train_step(
                params, opt_state,
                feats.to(device) if data_mesh is None else feats,
                torch.from_numpy(labels).to(device),
                torch.from_numpy(row_mask).to(device), active, hp)
            epoch_loss += loss_vals.cpu().numpy() * len(idx)

        logits_all = []
        for s in range(0, len(eval_feats), base.eval_batch_size):
            chunk = np.ascontiguousarray(
                eval_feats[s: s + base.eval_batch_size])
            sharded = data_mesh is not None and len(chunk) % len(
                data_mesh.mesh) == 0
            logits_all.append(stacked_eval_logits(
                params, chunk, model_cfg, base.dtype, device,
                shared_batch=True, mesh=data_mesh if sharded else None))
        # an empty eval split (an empty-but-present val npy): the guard of
        # loop._predict
        eval_logits = (np.concatenate(logits_all, axis=1) if logits_all
                       else np.zeros((T, 0, 2), np.float32))

        rung_values: list[tuple[int, float]] = []
        for t in range(T):
            prog = progs[t]
            if prog.stopped:
                continue
            m = metrics_mod.compute_metrics_from_logits(eval_logits[t],
                                                        eval_y)
            m["loss"] = float(epoch_loss[t] / n)
            prog.history.append({"epoch": epoch, **m})
            print(f"[Trial {mine[t]} Epoch {epoch}/{num_epochs}] "
                  f"loss={m['loss']:.4f} eval_f1={m['f1']:.4f}")

            L.epoch_bookkeeping(
                base, fold_dirs[t], epoch, steps_per_epoch,
                checkpoint_limit, m, has_val, prog,
                snapshot=lambda t=t: (
                    member(params, t),
                    L.sequential_opt_layout(member(opt_state, t))),
                rng_state=epoch_rng.bit_generator.state,
                label=f" trial {mine[t]}:", mesh=data_mesh)
            if not prog.stopped and epoch in rungs:
                rung_values.append((mine[t], m[rung_metric]))

        if mesh is not None:  # every group's trials at the rung
            rung_values = _gather_groups(rung_values, mesh, data_per_trial)
        if len(rung_values) >= 2:
            med = float(np.median([v for _, v in rung_values]))
            for trial, v in rung_values:
                worse = v < med if goal == "maximize" else v > med
                if worse and trial in mine:
                    t = mine.index(trial)
                    print(f"[Hyperband] cut trial {trial} at rung {epoch}: "
                          f"{v:.4f} vs median {med:.4f}")
                    progs[t].stopped = True
                    cut_at_rung[t] = epoch
        if _all_stopped(progs, mesh):
            break

    all_metrics = []
    single_eval = steps.make_eval_step(model_cfg, dtype=base.dtype,
                                       mesh=data_mesh, device=device)
    for t in range(T):
        prog = progs[t]
        if prog.best_params is None:
            prog.best_params = member(params, t)
        m = L.finalize_fold(
            fold, cfgs[t], fold_dirs[t], model_cfg, mean, std,
            prog.best_params, prog.best_epoch, prog.best_f1, eval_feats,
            eval_y, has_val, test_feats, np.asarray(test_y, np.int64),
            single_eval, device, None, prog.history,
            class_weights=class_weights, mesh=data_mesh)
        if cut_at_rung[t] is not None:
            m["hyperband_cut_at_epoch"] = cut_at_rung[t]
        all_metrics.append(m)
    return _gather_groups(all_metrics, mesh, data_per_trial)
