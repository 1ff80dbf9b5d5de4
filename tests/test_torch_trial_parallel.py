"""The port's trial-parallel sweep trainer (`train/trial_parallel.py`)
against the JAX package's and against sequential trials of the port's
`train_fold`.

One fold (11 train clips at batch 4: a padded tail batch), 3 epochs,
hidden 32, 2 layers, 128 frames, f32, on the CPU, with the three trials of
tests/test_trial_parallel.py (both branch points γ=0 and ls=0 and the
swept space); stage 1, and stage 2 with class weights. Both packages start
from ONE parameter tree (each `init_model` returns the JAX `init_params`
tree). Per-epoch loss, F1 and accuracy and the trial metrics agree at
1e-4. Also the simultaneous Hyperband cut and the refusals."""

import dataclasses
import json

import pytest
import torch

from zenker_audio_detection_tpu.train import loop as JL
from zenker_audio_detection_tpu_torch.train import loop as L
from zenker_audio_detection_tpu_torch.train import trial_parallel as TP

from test_torch_fold_parallel import _jax_tree, _patch_init, make_folds

TOL = 1e-4
TRIALS = [  # tests/test_trial_parallel.py:60-67
    dict(learning_rate=1e-3, weight_decay=0.01, adam_beta2=0.98,
         warmup_ratio=0.1, focal_gamma=0.0, label_smoothing=0.0),
    dict(learning_rate=3e-4, weight_decay=0.05, adam_beta2=0.95,
         warmup_ratio=0.25, focal_gamma=2.0, label_smoothing=0.1),
    dict(learning_rate=2e-3, weight_decay=0.0, adam_beta2=0.999,
         warmup_ratio=0.0, focal_gamma=1.0, label_smoothing=0.07),
]
COMMON = dict(num_epochs=3, batch_size=4, eval_batch_size=4,
              enable_early_stopping=True, augment=False, seed=42)
STAGE_KW = {"stage1": {}, "stage2": {"use_class_weights": True}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for these small tensors (and for child
    processes, through OMP_NUM_THREADS): the suite runs in several worker
    processes on a few cores, where each process's thread pool would
    oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    return root, make_folds(root, sizes=((1, 11),)), _jax_tree()


def _cfgs(make, root, data_dir, tag, stage, **kw):
    return [make(stage=stage, data_dir=data_dir,
                 output_root=str(root / f"{tag}_t{i}"),
                 **COMMON, **STAGE_KW[stage], **trial, **kw)
            for i, trial in enumerate(TRIALS)]


@pytest.fixture(scope="module", params=["stage1", "stage2"])
def runs(request, data):
    """JAX trial-parallel, port trial-parallel and the port's sequential
    trials, from one tree; (root, stage, port, JAX, sequential)."""
    import jax.numpy as jnp
    from zenker_audio_detection_tpu.train.trial_parallel import (
        train_trials_parallel as jax_parallel)

    root, data_dir, tree = data
    stage = request.param
    with pytest.MonkeyPatch.context() as mp:
        _patch_init(mp, tree)
        want = jax_parallel(1, _cfgs(
            lambda **kw: JL.TrainFoldConfig(dtype=jnp.float32, **kw),
            root, data_dir, f"jax_{stage}", stage))
        cfgs = _cfgs(lambda **kw: L.TrainFoldConfig(
            dtype=torch.float32, device="cpu", **kw), root, data_dir,
            f"par_{stage}", stage)
        got = TP.train_trials_parallel(1, cfgs)
        seq = [L.train_fold(1, dataclasses.replace(
            c, output_root=str(root / f"seq_{stage}_t{t}")))
            for t, c in enumerate(cfgs)]
    return root, stage, got, want, seq


def _history(root, tag, t):
    return json.loads((root / f"{tag}_t{t}" / "fold1" / "history.json")
                      .read_text())


@pytest.mark.parametrize("trial", range(len(TRIALS)))
def test_epochs_match_jax_and_sequential(runs, trial):
    root, stage, *_ = runs
    got = _history(root, f"par_{stage}", trial)
    for other in (f"jax_{stage}", f"seq_{stage}"):
        want = _history(root, other, trial)
        assert [h["epoch"] for h in got] == [h["epoch"] for h in want]
        for g, w in zip(got, want):
            for key in ("loss", "f1", "accuracy"):
                assert g[key] == pytest.approx(w[key], abs=TOL), (other, g, w)


@pytest.mark.parametrize("trial", range(len(TRIALS)))
def test_trial_metrics_match_jax_and_sequential(runs, trial):
    root, stage, got, want, seq = runs
    for other in (want[trial], seq[trial]):
        assert set(got[trial]) == set(other)
        for key, value in other.items():
            if "runtime" not in key and "per_second" not in key:
                assert got[trial][key] == pytest.approx(value, abs=TOL), key
    assert (root / f"par_{stage}_t{trial}" / "fold1" / "best" /
            "model.safetensors").exists()


def test_hyperband_rung_cut_masks_trials(data):
    """A rung at epoch 1 cutting on loss: the trials above the median stop,
    their history freezes at the rung and the cut is in their metrics; the
    others train on."""
    root, data_dir, tree = data
    cfgs = _cfgs(lambda **kw: L.TrainFoldConfig(
        dtype=torch.float32, device="cpu", **kw), root, data_dir, "hb",
        "stage1")
    cfgs = [dataclasses.replace(c, num_epochs=2, enable_early_stopping=False)
            for c in cfgs]
    with pytest.MonkeyPatch.context() as mp:
        _patch_init(mp, tree)
        out = TP.train_trials_parallel(1, cfgs, rungs=[1], goal="minimize",
                                       rung_metric="loss")
    cut = [t for t, m in enumerate(out) if "hyperband_cut_at_epoch" in m]
    assert cut and len(cut) < len(out)
    for t, m in enumerate(out):
        hist = _history(root, "hb", t)
        assert len(hist) == (1 if t in cut else 2)


@pytest.mark.parametrize("change,match", [
    ({"num_epochs": 5}, "num_epochs"),
    ({"grad_accum": 8}, "grad_accum"),
    ({"device": "cuda"}, "device"),
    ({"output_root": "same"}, "distinct output_root")])
def test_trials_refuse_mismatched_configs(tmp_path, change, match):
    cfgs = [L.TrainFoldConfig(output_root=str(tmp_path / f"t{i}"),
                              device="cpu", **trial)
            for i, trial in enumerate(TRIALS)]
    if "output_root" in change:
        cfgs = [dataclasses.replace(c, output_root="same") for c in cfgs]
    else:
        cfgs[1] = dataclasses.replace(cfgs[1], **change)
    with pytest.raises(ValueError, match=match):
        TP.train_trials_parallel(1, cfgs)
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("kw,match", [
    ({"streaming": True}, "streaming"),
    ({"grad_accum": 2}, "gradient accumulation"),
    ({"resume": True}, "resume"),
    ({"on_epoch_end": lambda e, m: False}, "on_epoch_end")])
def test_trials_refusals(tmp_path, kw, match):
    cfgs = [L.TrainFoldConfig(output_root=str(tmp_path / f"t{i}"),
                              device="cpu", **trial, **kw)
            for i, trial in enumerate(TRIALS)]
    with pytest.raises(ValueError, match=match):
        TP.train_trials_parallel(1, cfgs)
