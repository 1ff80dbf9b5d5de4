#!/usr/bin/env python3
"""The drift bench's stage 1 in the JAX package and in the port, on the CPU.

    python3 tools/drift_jax_vs_port.py [--workdir DIR] [--splits FILE]

Runs the drift recipe's stage 1 (tools/drift_bisect.py: the seeded corpus,
its fold-1 splits, compute_stats, the stage-1 trainer with --f32
--no-augment, 12 epochs, lr 1e-2, batch 8, from the frozen drift init) in
both packages on the CPU, each with its own statistics and features, and
prints:

  - the components on one input each, port against JAX: the statistics,
    the features of the train split (JAX's statistics), the f32 logits of
    the init on the val split, and the first epoch's steps in split order
    on JAX's features (the largest loss difference, the parameters after
    the epoch);
  - per package, the val F1 after each epoch, the best epoch, the stage-1
    f32 AUC and the AUC of every epoch's parameters;
  - the relative distance of the port's parameters to JAX's after each
    epoch, and the same without `encoder.k.bias` (a leaf whose gradient is
    rounding noise, which Adam turns into steps of the learning rate).

Needs both packages and runs only on the CPU (the JAX package is the
reference; this tool is not part of the port). About 10 minutes on 8
cores. One JSON line last.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(Path.cwd()))
sys.path.insert(0, str(HERE))
NOISE_LEAF = "encoder.k.bias"


def jax_config(data_dir: str, output_root: str, pretrained: str):
    """The JAX trainer's config of drift_bisect.RECIPE (its CLI's own
    construction, cli/train_stage1.py)."""
    import jax.numpy as jnp

    import drift_bisect
    from zenker_audio_detection_tpu.cli import _train_common
    from zenker_audio_detection_tpu.train import loop

    ap = argparse.ArgumentParser()
    _train_common.add_common_train_args(ap, "stage1")
    a = ap.parse_args(drift_bisect.RECIPE + [
        "--data-dir", data_dir, "--output-root", output_root,
        "--pretrained-model-dir", pretrained])
    return loop.TrainFoldConfig(
        stage="stage1", data_dir=a.data_dir, output_root=a.output_root,
        pretrained_model_dir=a.pretrained_model_dir,
        num_epochs=a.num_epochs, batch_size=a.batch_size,
        grad_accum=a.grad_accum,
        learning_rate=_train_common.effective_lr(a),
        weight_decay=a.weight_decay, warmup_ratio=a.warmup_ratio,
        adam_beta2=a.adam_beta2, focal_gamma=a.focal_gamma,
        label_smoothing=a.label_smoothing,
        enable_early_stopping=not a.no_early_stopping,
        augment=not a.no_augment, seed=a.seed, dtype=jnp.float32)


def port_tree(jax_tree):
    """A JAX parameter tree (numpy leaves) in the port's layout."""
    from zenker_audio_detection_tpu_torch.models import convert

    return convert.params_from_jax(jax_tree)


def dist(a, b, skip=()) -> float:
    """||a - b|| / ||b|| over the leaves of two port trees, `skip` left
    out."""
    from zenker_audio_detection_tpu_torch.train import optim

    other = dict(optim.tree_items(b))
    num = den = 0.0
    for path, x in optim.tree_items(a):
        if ".".join(path) in skip:
            continue
        x, y = x.double(), other[path].double()
        num += float((x - y).square().sum())
        den += float(y.square().sum())
    return math.sqrt(num / den)


def components(ws: dict) -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    import drift_bisect
    from zenker_audio_detection_tpu.data import stats as jstats
    from zenker_audio_detection_tpu.train import loop as jloop
    from zenker_audio_detection_tpu.train import optim as joptim
    from zenker_audio_detection_tpu.train import steps as jsteps
    from zenker_audio_detection_tpu_torch.data import stats
    from zenker_audio_detection_tpu_torch.train import loop, optim, steps

    out = {}
    js = jstats.compute_fold_stats(ws["data"], 1)
    ps = stats.compute_fold_stats(ws["data"], 1, "cpu")
    out["stats"] = {"jax": js, "port": ps,
                    "mean_rel": abs(ps["mean"] - js["mean"]) / abs(js["mean"]),
                    "std_rel": abs(ps["std"] - js["std"]) / js["std"]}
    mean, std = js["mean"], js["std"]
    jcfg = jax_config(ws["data"], "unused", ws["pretrained"])
    pcfg = drift_bisect.train_config(ws["data"], "unused", ws["pretrained"],
                                     "cpu")
    train_x, train_y, _, _, val_x, _ = loop.load_fold_splits(1, pcfg)
    jparams, jmodel = jloop.init_model(jcfg)
    pparams, pmodel = loop.init_model(pcfg)
    out["init_rel"] = dist(pparams, port_tree(jax.tree.map(np.asarray,
                                                           jparams)))
    mf = pmodel.max_length
    jf = jloop.featurize_paths(train_x, mean, std, max_frames=mf)
    pf = loop.featurize_paths(train_x, mean, std, max_frames=mf, device="cpu")
    out["feat"] = {"max_abs": float(np.abs(pf - jf).max()),
                   "max_ref": float(np.abs(jf).max())}
    jv = jloop.featurize_paths(val_x, mean, std, max_frames=mf)
    jl = np.asarray(jsteps.make_eval_step(jmodel, dtype=jnp.float32)(
        jparams, jnp.asarray(jv)))
    pl = steps.make_eval_step(pmodel, dtype=torch.float32)(
        pparams, torch.from_numpy(jv)).numpy()
    out["eval"] = {"max_abs_logit": float(np.abs(pl - jl).max())}
    # the first epoch's steps in split order on JAX's features
    n, bs = len(train_x), pcfg.batch_size
    total = pcfg.num_epochs * -(-n // bs)
    jtx = joptim.make_optimizer(jcfg.learning_rate, total, jcfg.warmup_ratio,
                                jcfg.weight_decay, beta2=jcfg.adam_beta2)
    ptx = optim.make_optimizer(pcfg.learning_rate, total, pcfg.warmup_ratio,
                               pcfg.weight_decay, beta2=pcfg.adam_beta2)
    jstep = jsteps.make_train_step(jtx, jmodel, jloop._make_loss(jcfg, None),
                                   dtype=jnp.float32)
    pstep = steps.make_train_step(ptx, pmodel, loop._make_loss(pcfg, None),
                                  dtype=torch.float32)
    jp, jo, pp, po = jparams, jtx.init(jparams), pparams, ptx.init(pparams)
    y = train_y.astype(np.int32)
    diffs = []
    for s in range(0, n, bs):
        jp, jo, jlv, _ = jstep(jp, jo, jnp.asarray(jf[s: s + bs]),
                               jnp.asarray(y[s: s + bs]))
        pp, po, plv, _ = pstep(pp, po, torch.from_numpy(jf[s: s + bs]),
                               torch.from_numpy(y[s: s + bs].astype(
                                   np.int64)))
        diffs.append(abs(float(jlv) - float(plv)))
    jt = port_tree(jax.tree.map(np.asarray, jp))
    out["steps"] = {"loss_max_diff_epoch1": max(diffs),
                    "params_rel_after_epoch1": dist(pp, jt),
                    "params_rel_after_epoch1_without_k_bias": dist(
                        pp, jt, (NOISE_LEAF,))}
    return out


def train(pkg: str, ws: dict) -> tuple[dict, list]:
    """One stage-1 run of the recipe in `pkg` ("jax" or "port"), on the
    CPU: its per-epoch F1, best epoch, AUCs and per-epoch parameters (port
    layout)."""
    import jax

    import drift_bisect
    from zenker_audio_detection_tpu_torch.models import convert as pconv
    from zenker_audio_detection_tpu_torch.train import loop as ploop
    from zenker_audio_detection_tpu_torch.train import optim as poptim

    if pkg == "jax":
        from zenker_audio_detection_tpu.analysis import drift_bench
        from zenker_audio_detection_tpu.data import stats
        from zenker_audio_detection_tpu.models import convert
        from zenker_audio_detection_tpu.train import loop
    else:
        from zenker_audio_detection_tpu_torch.analysis import drift_bench
        from zenker_audio_detection_tpu_torch.data import stats
        from zenker_audio_detection_tpu_torch.models import convert
        from zenker_audio_detection_tpu_torch.train import loop
    root = os.path.join(os.path.dirname(ws["data"]), f"vs_{pkg}")
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "data_ast_stage1")
    shutil.copytree(ws["data"], data)
    out_root = os.path.join(root, "runs", "ast_classifier_stage1")
    if pkg == "jax":
        stats.compute_all_stats(data, data, 1)
        cfg = jax_config(data, out_root, ws["pretrained"])
    else:
        stats.compute_all_stats(data, data, 1, "cpu")
        cfg = drift_bisect.train_config(data, out_root, ws["pretrained"],
                                        "cpu")
    epochs, final = [], {}
    orig_book, orig_final = loop.epoch_bookkeeping, loop.finalize_fold

    def epoch_bookkeeping(*a, **kw):
        params, _ = kw["snapshot"]()
        if pkg == "jax":
            params = port_tree(jax.tree.map(np.array, params))
        else:
            params = poptim.tree_map(lambda t: t.detach().clone(), params)
        epochs.append((a[5]["f1"], params))
        return orig_book(*a, **kw)

    def finalize_fold(fold, cfg_, fold_dir, model_cfg, mean, std,
                      best_params, best_epoch, *a, **kw):
        final.update(model_cfg=model_cfg, mean=mean, std=std,
                     best_epoch=best_epoch)
        return orig_final(fold, cfg_, fold_dir, model_cfg, mean, std,
                          best_params, best_epoch, *a, **kw)

    loop.epoch_bookkeeping, loop.finalize_fold = (epoch_bookkeeping,
                                                  finalize_fold)
    try:
        loop.train_fold(1, cfg)
    finally:
        loop.epoch_bookkeeping, loop.finalize_fold = orig_book, orig_final

    def auc(r):
        if pkg == "jax":
            return drift_bench.drift_auc(ws["overlap"], "stage1", r)
        return drift_bench.drift_auc(ws["overlap"], "stage1", r, "cpu")

    epoch_aucs = []
    for k, (_, params) in enumerate(epochs, 1):
        eroot = os.path.join(root, f"epoch{k}")
        d = os.path.join(eroot, "ast_classifier_stage1", "fold1", "best")
        if pkg == "jax":
            tree = pconv.params_to_numpy(params)
            convert.save_hf_model_dir(
                tree, final["model_cfg"], d, {0: "Idle", 1: "Swallow"})
        else:
            pconv.save_hf_model_dir(params, final["model_cfg"], d,
                                    {0: "Idle", 1: "Swallow"})
        ploop.save_feature_extractor_config(
            d, final["mean"], final["std"],
            max_length=final["model_cfg"].max_length)
        epoch_aucs.append(round(auc(eroot), 6))
    res = {"mean": final["mean"], "std": final["std"],
           "val_f1": [round(f, 4) for f, _ in epochs],
           "best_epoch": final["best_epoch"],
           "auc": round(auc(os.path.join(root, "runs")), 6),
           "epoch_auc": epoch_aucs}
    print(f"[vs] {pkg}: mean {res['mean']:.6f} std {res['std']:.6f}; val F1 "
          f"{res['val_f1']}; best epoch {res['best_epoch']}; stage-1 f32 AUC "
          f"{res['auc']}; each epoch's AUC {epoch_aucs}", flush=True)
    return res, [p for _, p in epochs]


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    import drift_bisect

    parser = argparse.ArgumentParser()
    parser.add_argument("--workdir")
    parser.add_argument("--splits", help="fold-1 stage-1 splits to train "
                        "on (tools/drift_bisect.py --save-splits)")
    args = parser.parse_args()
    if args.splits:
        args.splits = os.path.abspath(args.splits)
    workdir = os.path.abspath(args.workdir or tempfile.mkdtemp(
        prefix="drift_vs_"))
    os.makedirs(workdir, exist_ok=True)
    cwd = os.getcwd()
    try:
        ws = drift_bisect.prepare(workdir, args.splits)
        print(f"[vs] inputs: {drift_bisect.digests(workdir, torch)}",
              flush=True)
        comp = components(ws)
        print(f"[vs] components alone, port vs JAX on the CPU: {comp}",
              flush=True)
        results, params = {}, {}
        for pkg in ("jax", "port"):
            results[pkg], params[pkg] = train(pkg, ws)
    finally:
        os.chdir(cwd)
        if not args.workdir:
            shutil.rmtree(workdir, ignore_errors=True)
    d = [dist(p, j) for p, j in zip(params["port"], params["jax"])]
    d_nk = [dist(p, j, (NOISE_LEAF,))
            for p, j in zip(params["port"], params["jax"])]
    print(f"[vs] port vs JAX after each epoch: relative parameter distance "
          f"{[float(f'{x:.3g}') for x in d]}; without {NOISE_LEAF} "
          f"{[float(f'{x:.3g}') for x in d_nk]}", flush=True)
    print(json.dumps({"components": comp, "runs": results, "dist": d,
                      "dist_without_k_bias": d_nk}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
