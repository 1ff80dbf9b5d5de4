#!/usr/bin/env python3
"""Bisects the drift bench's stage 1 between the card and the CPU.

    python3 tools/drift_bisect.py [--runs cpu cuda stats_cpu feat_cpu
        steps_cpu eval_cpu score_cpu] [--workdir DIR] [--card cuda]
        [--splits FILE] [--save-splits FILE]

Runs the drift recipe's stage 1 (analysis/drift_bench.py: the seeded
corpus, its fold-1 splits, compute_stats, then the stage-1 trainer with
--f32 --no-augment, 12 epochs, lr 1e-2, batch 8, no early stopping, from
the frozen drift init) and scores its best/ like the bench (drift_auc on
the stage-1 overlap corpus). Each of the five components runs on a device
of its own:

  stats  the statistics' log-mel (data/stats.py)
  feat   the featurization of the train, val and test splits
         (train/loop.py:featurize_paths)
  steps  the training steps (train/steps.py, under train_fold's
         deterministic cuDNN)
  eval   the per-epoch evaluation that picks the best epoch, and the
         final metrics (steps.make_eval_step)
  score  the scoring of best/ (analysis/roc_pr.analyze)

A run is named by the components it moves: "cuda" (all on the card),
"cpu" (all on the CPU), "<component>_cpu" (that one on the CPU, the rest
on the card). "cpu" runs first whenever it is asked for: every other run
prints its parameters' relative distance to it after each epoch. For each
run one line: the statistics, the val F1 after each epoch, the best epoch,
the stage-1 f32 AUC, the AUC of every epoch's parameters (scored on the
run's score device) and the distances.

Before the runs: the versions of python, numpy and torch and digests of
the inputs (the corpus, the fold-1 splits, the overlap corpus, the
pretrained weights), so that two machines' runs can be told apart from
their devices; then each component alone on one input, card against CPU:
the statistics, the features of the train split (both with the CPU's
statistics), the f32 logits of the init on the val split, and the first
epoch's steps in split order on the CPU's features (the gradients of the
first batch, the largest loss difference, the parameters after the
epoch).

The fold splits follow the file system's `os.listdir` order (as the
reference's and the JAX package's do), so two machines may train on other
splits of the same corpus: `--save-splits FILE` writes this machine's
fold-1 stage-1 splits, `--splits FILE` trains on those of another.
`--card cpu` runs the same code with the CPU standing in for the card (a
check of the tool, not a bisection). Prints the card's name and power
limit first and one JSON line last. Imports only the port; run from a
checkout's root.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path.cwd()))
COMPONENTS = ("stats", "feat", "steps", "eval", "score")
RUNS = ("cpu", "cuda", *(f"{c}_cpu" for c in COMPONENTS))
FOLD = 1
# analysis/drift_bench.py:prepare_and_train's stage-1 flags
RECIPE = ["--fold", "1", "--num-epochs", "12", "--batch-size", "8",
          "--learning-rate", "1e-2", "--no-augment", "--f32",
          "--no-early-stopping"]


def devices_of(run: str, card: str) -> dict:
    if run == "cpu":
        return dict.fromkeys(COMPONENTS, "cpu")
    devs = dict.fromkeys(COMPONENTS, card)
    if run != "cuda":
        devs[run[: -len("_cpu")]] = "cpu"
    return devs


def rel_dist(a, b) -> float:
    """||a - b|| / ||b|| over every leaf of two parameter trees."""
    from zenker_audio_detection_tpu_torch.train import optim

    other = dict(optim.tree_items(b))
    num = den = 0.0
    for path, x in optim.tree_items(a):
        x, y = x.double().cpu(), other[path].double().cpu()
        num += float((x - y).square().sum())
        den += float(y.square().sum())
    return math.sqrt(num / den)


def train_config(data_dir: str, output_root: str, pretrained: str,
                 device: str):
    from zenker_audio_detection_tpu_torch.cli import _train_common

    ap = argparse.ArgumentParser()
    _train_common.add_common_train_args(ap, "stage1")
    args = ap.parse_args(RECIPE + [
        "--data-dir", data_dir, "--output-root", output_root,
        "--pretrained-model-dir", pretrained, "--device", device])
    return _train_common.train_config(args, "stage1")


def prepare(workdir: str, splits: str | None = None,
            save_splits: str | None = None) -> dict:
    """The bench's corpus, pretrained init, fold splits and stage-1 overlap
    corpus in `workdir` (its CLIs write relative to the working
    directory). The splits follow `os.listdir` order, as the reference's
    do, so two file systems may split the same corpus differently:
    `splits` (a JSON file `save_splits` wrote) replaces the stage-1 fold-1
    splits by another machine's; `save_splits` writes them, paths relative
    to the working directory."""
    from zenker_audio_detection_tpu_torch.analysis import drift_bench
    from zenker_audio_detection_tpu_torch.cli import (prepare_training_data,
                                                      prepare_two_stage)

    os.chdir(workdir)
    short, _ = drift_bench.build_workflow_corpus(workdir)
    pretrained = drift_bench.build_pretrained(workdir)
    prepare_training_data.main(["--dataset-root", short])
    prepare_two_stage.main(["--val-ratio", "0.25"])
    d1, _ = drift_bench.build_overlap_eval(workdir)
    data = os.path.join(workdir, "data_ast_stage1")
    names = [f"{split}_{ax}_fold{FOLD}" for split in ("train", "val", "test")
             for ax in ("x", "y")]
    if splits:
        with open(splits) as f:
            given = json.load(f)
        for name in names:
            a = given[name]
            np.save(os.path.join(data, name + ".npy"),
                    np.asarray([os.path.join(workdir, v) for v in a], object)
                    if "_x_" in name else np.asarray(a))
    if save_splits:
        out = {}
        for name in names:
            a = np.load(os.path.join(data, name + ".npy"),
                        allow_pickle=True).tolist()
            out[name] = ([os.path.relpath(v, workdir) for v in a]
                         if "_x_" in name else [int(v) for v in a])
        os.makedirs(os.path.dirname(os.path.abspath(save_splits)),
                    exist_ok=True)
        with open(save_splits, "w") as f:
            json.dump(out, f)
    return {"pretrained": pretrained, "data": data, "overlap": d1}


def digests(workdir: str, torch) -> dict:
    """The versions of the numeric libraries, and sha256 digests of what
    the runs start from: the training corpus's WAV bytes, the fold-1 splits
    (paths relative to the working directory, and labels), the stage-1
    overlap corpus and the pretrained weights; two machines whose digests
    agree train from the same data."""
    import hashlib

    def files(root, suffix):
        h = hashlib.sha256()
        for d, _, fs in sorted(os.walk(os.path.join(workdir, root))):
            for f in sorted(fs):
                if f.endswith(suffix):
                    h.update(os.path.relpath(os.path.join(d, f),
                                             workdir).encode())
                    with open(os.path.join(d, f), "rb") as fh:
                        h.update(fh.read())
        return h.hexdigest()[:16]

    h = hashlib.sha256()
    for split in ("train", "val", "test"):
        for ax in ("x", "y"):
            a = np.load(os.path.join(workdir, "data_ast_stage1",
                                     f"{split}_{ax}_fold{FOLD}.npy"),
                        allow_pickle=True).tolist()
            h.update(repr([os.path.relpath(v, workdir) if ax == "x" else v
                           for v in a]).encode())
    return {"python": sys.version.split()[0], "numpy": np.__version__,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "corpus": files("Short", ".wav"), "splits": h.hexdigest()[:16],
            "overlap": files("overlap_wavs_stage1", ".wav"),
            "pretrained": files("pretrained", ".safetensors")}


def components(ws: dict, card: str, torch) -> dict:
    """Each component alone, card against CPU, on one input."""
    from zenker_audio_detection_tpu_torch.data import stats
    from zenker_audio_detection_tpu_torch.train import loop, optim, steps

    out = {}
    st = {dev: stats.compute_fold_stats(ws["data"], FOLD, dev)
          for dev in ("cpu", card)}
    out["stats"] = {"cpu": st["cpu"], card: st[card], "mean_rel": abs(
        st[card]["mean"] - st["cpu"]["mean"]) / abs(st["cpu"]["mean"]),
        "std_rel": abs(st[card]["std"] - st["cpu"]["std"])
        / st["cpu"]["std"]}
    mean, std = st["cpu"]["mean"], st["cpu"]["std"]
    cfg = train_config(ws["data"], "unused", ws["pretrained"], "cpu")
    train_x, train_y, _, _, val_x, _ = loop.load_fold_splits(FOLD, cfg)
    params, model_cfg = loop.init_model(cfg)
    mf = model_cfg.max_length
    feats = {dev: loop.featurize_paths(train_x, mean, std, max_frames=mf,
                                       device=dev) for dev in ("cpu", card)}
    out["feat"] = {"max_abs": float(np.abs(feats[card] - feats["cpu"]).max()),
                   "max_ref": float(np.abs(feats["cpu"]).max())}
    val = loop.featurize_paths(val_x, mean, std, max_frames=mf, device="cpu")
    logits = {}
    for dev in ("cpu", card):
        p = optim.tree_map(lambda t: t.to(dev), params)
        logits[dev] = steps.make_eval_step(model_cfg, dtype=torch.float32)(
            p, torch.from_numpy(val).to(dev)).cpu()
    out["eval"] = {"max_abs_logit": float((logits[card] - logits["cpu"])
                                          .abs().max())}
    # the first epoch's steps in split order on the CPU's features, with
    # the recipe's schedule (its first step has learning rate 0: warmup)
    n, bs = len(train_x), cfg.batch_size
    x = torch.from_numpy(feats["cpu"])
    y = torch.from_numpy(train_y.astype(np.int64))
    tx = optim.make_optimizer(cfg.learning_rate, cfg.num_epochs * -(-n // bs),
                              cfg.warmup_ratio, cfg.weight_decay,
                              beta2=cfg.adam_beta2)
    loss = loop._make_loss(cfg, None)
    res = {}
    for dev in ("cpu", card):
        p = optim.tree_map(lambda t: t.to(dev), params)
        step = steps.make_train_step(tx, model_cfg, loss, dtype=torch.float32)
        losses = []
        with loop._deterministic_cudnn():
            _, g = steps.value_and_grad(steps.make_loss_fn(
                model_cfg, loss, dtype=torch.float32), p, x[:bs].to(dev),
                y[:bs].to(dev))
            o = tx.init(p)
            for s in range(0, n, bs):
                p, o, lv, _ = step(p, o, x[s: s + bs].to(dev),
                                   y[s: s + bs].to(dev))
                losses.append(float(lv))
        res[dev] = (losses, g, p)
    out["steps"] = {
        "grad_rel_first_batch": rel_dist(res[card][1], res["cpu"][1]),
        "loss_max_diff_epoch1": max(abs(a - b) for a, b in zip(
            res[card][0], res["cpu"][0])),
        "params_rel_after_epoch1": rel_dist(res[card][2], res["cpu"][2])}
    return out


def run(name: str, ws: dict, card: str, ref, torch) -> dict:
    """One stage-1 run of the recipe with its components' devices."""
    from zenker_audio_detection_tpu_torch.analysis import drift_bench
    from zenker_audio_detection_tpu_torch.data import stats
    from zenker_audio_detection_tpu_torch.models import convert
    from zenker_audio_detection_tpu_torch.train import loop, optim, steps

    devs = devices_of(name, card)
    root = os.path.join(os.path.dirname(ws["data"]), f"bisect_{name}")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "data_ast_stage1")
    shutil.copytree(ws["data"], data)
    stats.compute_all_stats(data, data, FOLD, devs["stats"])
    cfg = train_config(data, os.path.join(root, "runs",
                                          "ast_classifier_stage1"),
                       ws["pretrained"], devs["steps"])

    epochs, final = [], {}
    orig = {k: getattr(loop, k) for k in ("featurize_paths",
                                          "epoch_bookkeeping",
                                          "finalize_fold")}
    orig_eval = steps.make_eval_step

    def featurize_paths(*a, **kw):
        return orig["featurize_paths"](*a, **{**kw, "device": devs["feat"]})

    def make_eval_step(config, dtype=torch.bfloat16, mesh=None, device=None):
        inner = orig_eval(config, dtype=dtype, mesh=mesh,
                          device=devs["eval"])

        def step(params, chunk):
            p = optim.tree_map(lambda t: t.to(devs["eval"]), params)
            return inner(p, chunk.to(devs["eval"]))
        return step

    def epoch_bookkeeping(*a, **kw):
        params, _ = kw["snapshot"]()
        epochs.append((a[5]["f1"], optim.tree_map(
            lambda t: t.detach().to("cpu", copy=True), params)))
        return orig["epoch_bookkeeping"](*a, **kw)

    def finalize_fold(fold, cfg_, fold_dir, model_cfg, mean, std,
                      best_params, best_epoch, *a, **kw):
        final.update(model_cfg=model_cfg, mean=mean, std=std,
                     best_epoch=best_epoch, fold_dir=fold_dir)
        return orig["finalize_fold"](fold, cfg_, fold_dir, model_cfg, mean,
                                     std, best_params, best_epoch, *a, **kw)

    loop.featurize_paths = featurize_paths
    loop.epoch_bookkeeping = epoch_bookkeeping
    loop.finalize_fold = finalize_fold
    steps.make_eval_step = make_eval_step
    t0 = time.perf_counter()
    try:
        loop.train_fold(FOLD, cfg)
    finally:
        for k, f in orig.items():
            setattr(loop, k, f)
        steps.make_eval_step = orig_eval
    train_s = time.perf_counter() - t0
    auc = drift_bench.drift_auc(ws["overlap"], "stage1",
                                os.path.join(root, "runs"), devs["score"])
    epoch_aucs = []
    for k, (_, params) in enumerate(epochs, 1):
        eroot = os.path.join(root, f"epoch{k}")
        d = os.path.join(eroot, "ast_classifier_stage1", f"fold{FOLD}",
                         "best")
        convert.save_hf_model_dir(params, final["model_cfg"], d,
                                  {0: "Idle", 1: "Swallow"})
        loop.save_feature_extractor_config(
            d, final["mean"], final["std"],
            max_length=final["model_cfg"].max_length)
        epoch_aucs.append(round(drift_bench.drift_auc(
            ws["overlap"], "stage1", eroot, devs["score"]), 6))
    dists = ([rel_dist(p, q) for (_, p), q in zip(epochs, ref)]
             if ref is not None else None)
    result = {"devices": devs, "mean": final["mean"], "std": final["std"],
              "val_f1": [round(f, 4) for f, _ in epochs],
              "best_epoch": final["best_epoch"], "auc": round(auc, 6),
              "epoch_auc": epoch_aucs,
              "dist_to_cpu": [float(f"{x:.3g}") for x in dists]
              if dists is not None else None,
              "train_s": round(train_s, 1)}
    print(f"[bisect] {name} ({', '.join(f'{k} {v}' for k, v in devs.items())}"
          f"): mean {final['mean']:.6f} std {final['std']:.6f}; val F1 "
          f"{result['val_f1']}; best epoch {final['best_epoch']}; stage-1 "
          f"f32 AUC {result['auc']}; each epoch's AUC {epoch_aucs}; "
          f"distance to the cpu run after each epoch "
          f"{result['dist_to_cpu']}; training {train_s:.1f} s", flush=True)
    return result, epochs


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--runs", nargs="+", choices=RUNS, default=list(RUNS))
    parser.add_argument("--workdir")
    parser.add_argument("--card", default="cuda")
    parser.add_argument("--splits", help="a JSON of fold-1 stage-1 splits "
                        "(written by --save-splits) to train on instead")
    parser.add_argument("--save-splits", help="write the fold-1 stage-1 "
                        "splits here (paths relative to the working "
                        "directory)")
    args = parser.parse_args()
    for name in ("splits", "save_splits"):
        if getattr(args, name):
            setattr(args, name, os.path.abspath(getattr(args, name)))
    if args.card.startswith("cuda"):
        if not torch.cuda.is_available():
            print("drift_bisect: CUDA is not available", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip(),
              flush=True)
    workdir = os.path.abspath(args.workdir or tempfile.mkdtemp(
        prefix="drift_bisect_"))
    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    try:
        ws = prepare(workdir, args.splits, args.save_splits)
        env = digests(workdir, torch)
        print(f"[bisect] versions and input digests: {env}", flush=True)
        comp = components(ws, args.card, torch)
        print(f"[bisect] components alone, {args.card} vs cpu: {comp}",
              flush=True)
        runs = sorted(args.runs, key=lambda r: r != "cpu")
        results, ref = {}, None
        for name in runs:
            results[name], epochs = run(name, ws, args.card,
                                        ref, torch)
            if name == "cpu":
                ref = [p for _, p in epochs]
    finally:
        os.chdir(cwd)
        if not args.workdir:
            shutil.rmtree(workdir, ignore_errors=True)
    print(json.dumps({"card": args.card, "inputs": env, "components": comp,
                      "runs": results}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
