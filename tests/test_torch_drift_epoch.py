"""The drift bench's stage 1 (analysis/drift_bench.py), its first epoch in
both packages on the CPU: the seeded corpus and its fold-1 splits, each
package's compute_stats and featurization, its init from the frozen drift
checkpoint (h32/L2, `drift_init.npz`) with the head from `PRNGKey(42)`, and
the recipe's trainer (--f32 --no-augment, lr 1e-2, batch 8, the schedule
of 12 epochs; stopped after the first by `on_epoch_end`). This pins the
start of the drift bench's trajectory: the statistics within 1e-6
relative, the epoch's parameters within 1e-4 relative leaf by leaf (the
key bias, whose gradient is rounding noise, to the sum of the epoch's
learning rates), and the epoch's loss and val F1 equal (the loss at
1e-5)."""

import argparse
import dataclasses
import json
import os

import pytest
import torch

from zenker_audio_detection_tpu_torch.analysis import drift_bench
from zenker_audio_detection_tpu_torch.models import convert
from zenker_audio_detection_tpu_torch.train import optim

TOL = 1e-4
NOISE_LEAF = "encoder.k.bias"
# analysis/drift_bench.py:prepare_and_train's stage-1 flags
RECIPE = ["--fold", "1", "--num-epochs", "12", "--batch-size", "8",
          "--learning-rate", "1e-2", "--no-augment", "--f32",
          "--no-early-stopping"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stop_after_first(epoch, metrics):
    return epoch >= 1


def _port_config(argv):
    from zenker_audio_detection_tpu_torch.cli import _train_common

    ap = argparse.ArgumentParser()
    _train_common.add_common_train_args(ap, "stage1")
    cfg = _train_common.train_config(ap.parse_args(argv), "stage1")
    return dataclasses.replace(cfg, on_epoch_end=_stop_after_first)


def _jax_config(argv):
    """The JAX trainer's config, built as its cli/train_stage1.py does."""
    import jax.numpy as jnp

    from zenker_audio_detection_tpu.cli import _train_common
    from zenker_audio_detection_tpu.train import loop

    ap = argparse.ArgumentParser()
    _train_common.add_common_train_args(ap, "stage1")
    a = ap.parse_args(argv)
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
        augment=not a.no_augment, seed=a.seed, dtype=jnp.float32,
        on_epoch_end=_stop_after_first)


@pytest.fixture(scope="module")
def first_epoch(tmp_path_factory):
    from zenker_audio_detection_tpu.data import stats as jstats
    from zenker_audio_detection_tpu.train import loop as jloop
    from zenker_audio_detection_tpu_torch.cli import (prepare_training_data,
                                                      prepare_two_stage)
    from zenker_audio_detection_tpu_torch.data import stats
    from zenker_audio_detection_tpu_torch.train import loop

    wd = tmp_path_factory.mktemp("drift_epoch")
    prev = os.getcwd()
    os.chdir(wd)
    try:
        short, _ = drift_bench.build_workflow_corpus(str(wd))
        pretrained = drift_bench.build_pretrained(str(wd))
        prepare_training_data.main(["--dataset-root", short])
        prepare_two_stage.main(["--val-ratio", "0.25"])
        out = {}
        for pkg in ("jax", "port"):
            data = wd / pkg / "data_ast_stage1"
            data.mkdir(parents=True)
            for f in (wd / "data_ast_stage1").glob("*_fold1.npy"):
                (data / f.name).write_bytes(f.read_bytes())
            argv = RECIPE + ["--data-dir", str(data), "--output-root",
                             str(wd / pkg / "runs"),
                             "--pretrained-model-dir", pretrained]
            if pkg == "jax":
                _, agg = jstats.compute_all_stats(str(data), str(data), 1)
                jloop.train_fold(1, _jax_config(argv))
            else:
                _, agg = stats.compute_all_stats(str(data), str(data), 1,
                                                 "cpu")
                loop.train_fold(1, _port_config(argv + ["--device", "cpu"]))
            fold = wd / pkg / "runs" / "fold1"
            with open(fold / "history.json") as f:
                history = json.load(f)
            params, _ = convert.load_hf_model_dir(str(fold / "best"))
            out[pkg] = {"stats": agg, "history": history, "params": params}
    finally:
        os.chdir(prev)
    return out


def test_first_epoch_statistics_and_metrics(first_epoch):
    j, p = first_epoch["jax"], first_epoch["port"]
    for k in ("mean", "std"):
        assert abs(p["stats"][k] - j["stats"][k]) <= 1e-6 * abs(
            j["stats"][k]), k
    assert len(p["history"]) == len(j["history"]) == 1
    (hp,), (hj,) = p["history"], j["history"]
    assert hp["epoch"] == hj["epoch"] == 1
    assert hp["f1"] == hj["f1"] and hp["accuracy"] == hj["accuracy"]
    assert abs(hp["loss"] - hj["loss"]) <= 1e-5, (hp["loss"], hj["loss"])


def test_first_epoch_parameters(first_epoch):
    got = dict(optim.tree_items(first_epoch["port"]["params"]))
    want = dict(optim.tree_items(first_epoch["jax"]["params"]))
    assert got.keys() == want.keys()
    # the epoch's six learning rates: warmup of ceil(0.1 * 72) = 8 steps
    lr_sum = 1e-2 * sum(range(6)) / 8
    rel, bad = {}, {}
    for path, w in want.items():
        d = float((got[path].double() - w.double()).norm())
        name = ".".join(path)
        rel[name] = d / max(float(w.double().norm()), 1e-12)
        if name == NOISE_LEAF:
            ok = float((got[path] - w).abs().max()) <= lr_sum
        else:
            ok = rel[name] <= TOL
        if not ok:
            bad[name] = rel[name]
    worst = max((v, k) for k, v in rel.items() if k != NOISE_LEAF)
    print(f"largest relative leaf difference {worst[0]:.3g} ({worst[1]}); "
          f"{NOISE_LEAF} {rel[NOISE_LEAF]:.3g}")
    assert not bad, bad
