"""Hyperparameter sweeps: a local agent for W&B-format sweep configs.

The port of the JAX package's `tune/sweep.py`, on the port's trainers. The
reference optimizes with W&B random-search sweeps over fold 3
(wandb_sweeps/sweep_stage{1,2}_comprehensive.yaml: label-smoothing U(0,0.15),
focal-gamma U(0,3), lr logU(1e-5,1e-4), weight-decay logU(1e-3,0.1),
warmup U(0.05,0.25), beta2 U(0.95,0.999); stage 2 adds Hyperband
early-termination min_iter=3, eta=2, s=2). This module reads the SAME YAML
format (the repository's `sweeps/`), samples identically-distributed
configs, runs trials through the port's trainer (train/loop.py, or all at
once through train/trial_parallel.py) and applies a local Hyperband-style
rung cut: no W&B server required. Results land in sweep_results.jsonl +
best_config.json.

W&B agent interop (reference src/train_ast_stage2_cross_validation.py:
595-597,901-917): when a pre-existing `wandb.run` is active (the process was
launched by `wandb agent`; `utils.tracking.active_wandb_run`), trials REUSE
that run: its config is updated with the sampled parameters and the
objective is logged under its own name and the duplicated `test_*` metric
keys, the keys the reference's sweep objectives read.

PyYAML is imported only inside `load_sweep_config`, the one function that
reads a YAML file.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np

from ..utils import fsio, tracking

# sweep parameter name (reference YAML) -> TrainFoldConfig field
_PARAM_MAP = {
    "label-smoothing": "label_smoothing",
    "focal-gamma": "focal_gamma",
    "learning-rate": "learning_rate",
    "weight-decay": "weight_decay",
    "warmup-ratio": "warmup_ratio",
    "adam-beta2": "adam_beta2",
    "fold": "fold",
    "num-epochs": "num_epochs",
    "batch-size": "batch_size",
}
_IGNORED = {"wandb-group", "optim"}  # wandb plumbing / torch optimizer name


def load_sweep_config(path: str) -> dict:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ValueError(f"sweep config {path} must be a YAML mapping at "
                         f"the top level, got {type(cfg).__name__}")
    return cfg


def _range_bounds(name: str, spec: dict, *, positive: bool) -> tuple[float,
                                                                    float]:
    """Validated (min, max) from a distribution spec. Without this, a
    hand-edited YAML typo surfaces as numpy internals (KeyError 'min',
    'high <= 0', OverflowError for log of a nonpositive min) instead of a
    message naming the parameter."""
    missing = [k for k in ("min", "max") if k not in spec]
    if missing:
        raise ValueError(f"sweep parameter '{name}': distribution "
                         f"{spec.get('distribution')!r} needs "
                         f"{'/'.join(missing)} (got {spec!r})")
    try:
        lo, hi = float(spec["min"]), float(spec["max"])
    except (TypeError, ValueError):
        raise ValueError(f"sweep parameter '{name}': min/max must be "
                         f"numbers, got min={spec['min']!r} "
                         f"max={spec['max']!r}") from None
    if not (np.isfinite(lo) and np.isfinite(hi)) or lo > hi:
        raise ValueError(f"sweep parameter '{name}': need finite "
                         f"min <= max, got [{lo}, {hi}]")
    if positive and lo <= 0:
        raise ValueError(f"sweep parameter '{name}': "
                         f"log_uniform_values needs min > 0 in value "
                         f"space, got min={lo}")
    return lo, hi


def sample_parameters(parameters: dict, rng: np.random.Generator) -> dict:
    """One sample from a W&B-format parameter-space dict."""
    out: dict[str, Any] = {}
    for name, spec in parameters.items():
        if name in _IGNORED:
            continue
        if not isinstance(spec, dict):
            # a scalar / list here is a hand-edited YAML mistake (W&B
            # wraps constants as {value: x}); without this check it
            # surfaces as an AttributeError three branches down
            raise ValueError(f"sweep parameter '{name}' spec must be a "
                             f"mapping, got {type(spec).__name__}: {spec!r}")
        if "value" in spec:
            # canonical W&B constant form: {value: x}
            out[name] = spec["value"]
        elif "values" in spec:
            choices = spec["values"]
            if not isinstance(choices, (list, tuple)) or not choices:
                raise ValueError(f"sweep parameter '{name}': values must "
                                 f"be a non-empty list, got {choices!r}")
            out[name] = choices[int(rng.integers(len(choices)))]
        elif spec.get("distribution") == "uniform":
            lo, hi = _range_bounds(name, spec, positive=False)
            out[name] = float(rng.uniform(lo, hi))
        elif spec.get("distribution") == "log_uniform_values":
            # W&B: min/max in VALUE space
            lo, hi = _range_bounds(name, spec, positive=True)
            out[name] = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        elif spec.get("distribution") == "log_uniform":
            # W&B legacy: min/max already in LOG space (exp(U(min,max)))
            lo, hi = _range_bounds(name, spec, positive=False)
            out[name] = float(np.exp(rng.uniform(lo, hi)))
        else:
            raise ValueError(f"unsupported distribution for {name}: {spec}")
    return out


def hyperband_rungs(early_terminate: dict | None, max_epochs: int) -> list[int]:
    """Rung epochs for W&B hyperband (min_iter, eta, s)."""
    if not early_terminate or early_terminate.get("type") != "hyperband":
        return []
    min_iter = int(early_terminate.get("min_iter", 3))
    eta = int(early_terminate.get("eta", 2))
    s = int(early_terminate.get("s", 2))
    return [min_iter * eta ** k for k in range(s + 1)
            if min_iter * eta ** k < max_epochs]


def epoch_metric_key(metric: str) -> str:
    """Map a sweep objective name (eval_f1, test_loss, ...) onto the
    per-epoch metrics dict key used for rung cuts."""
    key = metric.split("_", 1)[1] if "_" in metric else metric
    if key not in ("f1", "accuracy", "precision", "recall", "loss"):
        raise ValueError(f"unsupported sweep objective {metric!r}: rung "
                         "cuts need one of f1/accuracy/precision/recall/"
                         "loss")
    return key


class HyperbandCut:
    """Median-based rung termination across trials."""

    def __init__(self, rungs: list[int], goal: str = "maximize",
                 metric_key: str = "f1"):
        self.rungs = rungs
        self.goal = goal
        self.metric_key = metric_key
        self.history: dict[int, list[float]] = {r: [] for r in rungs}

    def callback(self):
        """Per-trial on_epoch_end(epoch, metrics) -> stop?"""

        def on_epoch_end(epoch: int, metrics: dict) -> bool:
            if epoch not in self.rungs:
                return False
            value = metrics[self.metric_key]
            # snapshot the PRIOR trials' values before recording this one:
            # `prior = self.history[epoch]` would alias the list and let
            # the current trial contaminate its own cut median
            prior = list(self.history[epoch])
            self.history[epoch].append(value)
            if len(prior) >= 2:
                med = float(np.median(prior))
                worse = value < med if self.goal == "maximize" else value > med
                if worse:
                    print(f"[Hyperband] cut at rung {epoch}: "
                          f"{value:.4f} vs median {med:.4f}")
                    return True
            return False

        return on_epoch_end


def _log_trial_to_wandb(wb_run, sampled: dict, metric: str, value: float,
                        fold_metrics: dict, fold: int) -> None:
    """Reference sweep logging: config update + objective + duplicated
    `test_<name>` keys (:595-597) so either eval_* or test_* objectives
    resolve. Best-effort like every W&B touchpoint."""
    try:
        wb_run.config.update(sampled, allow_val_change=True)
        payload = {metric: value}
        for k, v in fold_metrics.items():
            # fold prefix stripped, so test_* metrics appear under the same
            # duplicated objective keys the reference logs (:595-597)
            payload[k.split(f"fold{fold}_", 1)[-1]] = v
        wb_run.log(payload)
    except Exception as exc:
        print(f"[Sweep][WARN] wandb trial log failed: {exc}")


def _objective_value(metrics: dict, fold: int, metric: str) -> float:
    """Resolve the sweep objective from the trial's final metrics:
    `eval_<m>` reads the validation split (test-during-train when no val
    split exists, like HF's eval loop), `test_<m>` the held-out test
    split. Unknown names fail loudly instead of silently optimizing F1."""
    # stored per-fold keys are HF-Trainer-shaped (fold{k}_{split}_eval_<m>,
    # test_trainer_exec_parity.py), so the bare metric name maps to eval_<m>
    if metric.startswith("test_"):
        candidates = [f"fold{fold}_test_eval_{metric[len('test_'):]}"]
    else:
        base = (metric[len("eval_"):] if metric.startswith("eval_")
                else metric)
        candidates = [f"fold{fold}_val_eval_{base}",
                      f"fold{fold}_test_during_train_eval_{base}"]
    for key in candidates:
        if key in metrics:
            return metrics[key]
    raise ValueError(f"sweep objective {metric!r} not found in trial "
                     f"metrics; available: {sorted(metrics)}")


def run_sweep(sweep_config_path: str, base_cfg, *, count: int = 10,
              seed: int = 0, output_dir: str = "sweep_results",
              parallel_trials: bool = False) -> dict:
    """Random-search agent: `count` trials of train_fold with sampled
    hyperparameters. `base_cfg` is a TrainFoldConfig providing everything
    the sweep doesn't set (its device among them). With `parallel_trials`,
    every trial trains at once in one vmapped step on that device
    (train/trial_parallel.py; the rung cut becomes the true simultaneous
    Hyperband median instead of the sequential streaming median)."""
    from ..parallel import mesh as pmesh
    from ..train import loop as train_loop

    sweep = load_sweep_config(sweep_config_path)
    if sweep.get("method", "random") != "random":
        raise ValueError(f"unsupported sweep method {sweep.get('method')}")
    params = sweep.get("parameters") or {}
    if not isinstance(params, dict):
        # catches `parameters:` written as a YAML list of names — without
        # this the num-epochs probe below AttributeErrors on a str key
        raise ValueError(f"sweep config {sweep_config_path}: 'parameters' "
                         f"must be a mapping of name -> spec, got "
                         f"{type(params).__name__}")
    unknown = [k for k in params
               if k not in _PARAM_MAP and k not in _IGNORED]
    if unknown:
        # a silently-dropped parameter would train every trial at the base
        # value while RECORDING the sampled one in sweep_results.jsonl
        raise ValueError(
            f"unsupported sweep parameter(s) {unknown}; supported: "
            f"{sorted(_PARAM_MAP)} (plumbing keys {sorted(_IGNORED)} are "
            f"ignored)")
    metric_block = sweep.get("metric") or {}
    metric = metric_block.get("name", "eval_f1")
    if "goal" in metric_block:
        goal = metric_block["goal"]
    elif "name" in metric_block:
        # user-named metric, no goal: W&B's documented default is MINIMIZE
        # (defaulting to maximize would invert goal-less loss objectives)
        goal = "minimize"
    else:
        # no metric block at all: the objective name 'eval_f1' above is OUR
        # default, so pairing it with minimize would be self-inconsistent
        goal = "maximize"
    if goal not in ("maximize", "minimize"):
        raise ValueError(f"unsupported sweep goal {goal!r}")
    # rungs derive from the EFFECTIVE epoch count: a num-epochs pinned in
    # the sweep parameters overrides base_cfg's default
    eff_epochs = base_cfg.num_epochs
    ne_spec = params.get("num-epochs")
    if ne_spec:
        if not isinstance(ne_spec, dict):
            raise ValueError(f"sweep parameter 'num-epochs' spec must be "
                             f"a mapping, got {ne_spec!r}")
        vals = ne_spec.get("values")
        if "value" in ne_spec:  # canonical W&B constant form
            eff_epochs = int(ne_spec["value"])
        elif vals and len(set(vals)) == 1:
            eff_epochs = int(vals[0])
        elif sweep.get("early_terminate"):
            raise ValueError("hyperband rungs are global: a SWEPT "
                             "num-epochs is unsupported with "
                             "early_terminate (pin it to one value)")
    rungs = hyperband_rungs(sweep.get("early_terminate"), eff_epochs)
    cutter = (HyperbandCut(rungs, goal, epoch_metric_key(metric))
              if rungs else None)

    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    results = []
    best = None

    def trial_cfg(trial, sampled):
        """(fold, overrides, cfg) for one sampled parameter set — shared by
        the sequential and parallel branches so they cannot drift."""
        fold = int(sampled.get("fold", 3))
        overrides = {_PARAM_MAP[k]: v for k, v in sampled.items()
                     if k in _PARAM_MAP and k != "fold"}
        cfg = dataclasses.replace(
            base_cfg, **overrides,
            output_root=os.path.join(output_dir, f"trial{trial}"))
        print(f"\n[Sweep trial {trial}] fold={fold} {overrides}")
        return fold, cfg

    # in a process group (several devices) every rank runs the agent on the
    # same draws and the first one writes
    writer = pmesh.is_main()

    def record_trial(trial, fold, sampled, metrics):
        nonlocal best
        value = _objective_value(metrics, fold, metric)
        record = {"trial": trial, "fold": fold, "params": sampled,
                  "objective": metric, "value": value, "metrics": metrics}
        results.append(record)
        wb_run = tracking.active_wandb_run() if writer else None
        if wb_run is not None:
            _log_trial_to_wandb(wb_run, sampled, metric, value, metrics, fold)
        if writer:
            with open(os.path.join(output_dir, "sweep_results.jsonl"),
                      "a") as f:
                f.write(json.dumps(record) + "\n")
        better = (best is None or
                  (value > best["value"] if goal == "maximize"
                   else value < best["value"]))
        if better:
            best = record
            # atomic: overwritten on every improvement; a kill mid-write
            # must not destroy the previous best along with the new one
            if writer:
                fsio.atomic_json_dump(
                    record, os.path.join(output_dir, "best_config.json"),
                    indent=2)
        print(f"[Sweep trial {trial}] {metric}={value:.4f} "
              f"(best={best['value']:.4f})")

    if parallel_trials:
        from ..train import trial_parallel

        samples = [sample_parameters(params, rng)
                   for _ in range(count)]
        if not samples:
            return {"results": results, "best": best}
        folds_cfgs = [trial_cfg(trial, s) for trial, s in enumerate(samples)]
        folds = {f for f, _ in folds_cfgs}
        if len(folds) > 1:
            raise ValueError("trial-parallel sweeps need a single fold; "
                             f"sampled {sorted(folds)} — pin 'fold' in the "
                             "sweep config or run sequentially")
        fold = folds.pop()
        # a parameter swept OUTSIDE trial_parallel.SWEPT_FIELDS (e.g. a
        # varying batch-size) is rejected by train_trials_parallel's
        # shared-field check; constants pinned via {"values": [x]} pass
        all_metrics = trial_parallel.train_trials_parallel(
            fold, [cfg for _, cfg in folds_cfgs], rungs=rungs, goal=goal,
            rung_metric=epoch_metric_key(metric) if rungs else "f1")
        for trial, (sampled, metrics) in enumerate(zip(samples, all_metrics)):
            record_trial(trial, fold, {k: v for k, v in sampled.items()
                                       if k != "fold"}, metrics)
        return {"results": results, "best": best}

    for trial in range(count):
        sampled = sample_parameters(params, rng)
        fold, cfg = trial_cfg(trial, sampled)
        cfg = dataclasses.replace(
            cfg, on_epoch_end=cutter.callback() if cutter else None)
        metrics = train_loop.train_fold(fold, cfg)
        record_trial(trial, fold, {k: v for k, v in sampled.items()
                                   if k != "fold"}, metrics)

    return {"results": results, "best": best}
