"""The port's sweep agent (`tune/sweep.py`) and its CLI (`cli/sweep.py`).

The pure-Python agent against the JAX package's (samples from the same
seeds, rungs, the Hyperband cut, objective resolution, the refusals of
malformed configs), the W&B run reuse through `utils.tracking`, and the
agent driving the port's trainers for real on a tiny tree: sequentially
and with `parallel_trials`, through `run_sweep` and through
`python -m zenker_audio_detection_tpu_torch.cli.sweep --parallel-trials`
on the CPU; the trial-parallel sweep records the same sampled parameters
and objective values as the sequential one (1e-4). Also the CLI's
refusals (the JAX agent's) and its need of CUDA without --device."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.tune import sweep as JS
from zenker_audio_detection_tpu_torch.cli import sweep as cli
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.models import convert
from zenker_audio_detection_tpu_torch.train import loop as L
from zenker_audio_detection_tpu_torch.tune import sweep as S
from zenker_audio_detection_tpu_torch.utils import tracking

from test_torch_fold_parallel import make_folds

REPO = Path(__file__).resolve().parent.parent
SWEEPS = [REPO / "sweeps" / f"sweep_stage{s}_comprehensive.yaml"
          for s in (1, 2)]


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


@pytest.mark.parametrize("path", SWEEPS, ids=["stage1", "stage2"])
def test_samples_and_rungs_match_jax(path):
    cfg = S.load_sweep_config(str(path))
    assert cfg == JS.load_sweep_config(str(path))
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(20):
        assert (S.sample_parameters(cfg["parameters"], rng)
                == JS.sample_parameters(cfg["parameters"], jrng))
    for epochs in (3, 10, 20):
        assert (S.hyperband_rungs(cfg.get("early_terminate"), epochs)
                == JS.hyperband_rungs(cfg.get("early_terminate"), epochs))


@pytest.mark.parametrize("spec", [
    {"lr": {"distribution": "uniform", "max": 1.0}},
    {"lr": {"distribution": "log_uniform_values", "min": 0, "max": 1e-2}},
    {"lr": {"values": []}},
    {"lr": {"values": 3}},
    {"lr": {"distribution": "uniform", "min": 2.0, "max": 1.0}},
    {"lr": 0.1}])
def test_malformed_specs_raise_as_jax(spec):
    for mod in (S, JS):
        with pytest.raises(ValueError, match="'lr'"):
            mod.sample_parameters(spec, np.random.default_rng(0))


def test_hyperband_cut_and_objective_match_jax():
    metrics = {"fold3_val_eval_f1": 0.8, "fold3_val_eval_loss": 0.4,
               "fold3_test_eval_f1": 0.7}
    for name in ("eval_f1", "eval_loss", "test_f1", "f1"):
        assert (S._objective_value(metrics, 3, name)
                == JS._objective_value(metrics, 3, name))
    with pytest.raises(ValueError, match="not found"):
        S._objective_value(metrics, 3, "eval_auroc")
    assert S.epoch_metric_key("eval_loss") == "loss"
    seq = [(2, {"loss": 0.5}), (2, {"loss": 0.3}), (2, {"loss": 0.9}),
           (1, {"loss": 9.0})]
    got, want = (S.HyperbandCut([2], "minimize", "loss"),
                 JS.HyperbandCut([2], "minimize", "loss"))
    assert ([got.callback()(e, m) for e, m in seq]
            == [want.callback()(e, m) for e, m in seq]
            == [False, False, True, False])


def test_sweep_reuses_an_active_wandb_run(tmp_path, monkeypatch):
    """A pre-existing wandb.run (the process launched by `wandb agent`) is
    reused through utils.tracking.active_wandb_run: its config takes the
    sampled parameters, the objective is logged with the duplicated
    test_* keys, and the run is not finished by the agent."""
    import types

    class Config(dict):
        def update(self, d, allow_val_change=False):
            dict.update(self, d)

    class Run:
        config = Config()
        logged: list = []
        finished = False

        def log(self, payload, step=None):
            self.logged.append(payload)

        def finish(self):
            self.finished = True

    run = Run()
    fake = types.ModuleType("wandb")
    fake.run = run
    monkeypatch.setitem(sys.modules, "wandb", fake)
    assert tracking.active_wandb_run() is run
    monkeypatch.setattr(L, "train_fold", lambda fold, cfg: {
        f"fold{fold}_val_eval_f1": 0.8, f"fold{fold}_test_eval_f1": 0.75})
    S.run_sweep(str(SWEEPS[0]), L.TrainFoldConfig(device="cpu"), count=1,
                output_dir=str(tmp_path / "sw"))
    assert not run.finished and "learning-rate" in run.config
    assert run.logged[0]["eval_f1"] == pytest.approx(0.8)
    assert run.logged[0]["test_eval_f1"] == pytest.approx(0.75)
    monkeypatch.delitem(sys.modules, "wandb")
    monkeypatch.setattr("builtins.__import__", _no_wandb(__import__))
    assert tracking.active_wandb_run() is None


def _no_wandb(real_import):
    def guarded(name, *args, **kw):
        if name == "wandb":
            raise ImportError("no wandb")
        return real_import(name, *args, **kw)
    return guarded


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One fold of 8 train clips and a tiny exported model, plus a sweep
    over lr and label smoothing pinned to fold 1."""
    import yaml

    root = tmp_path_factory.mktemp("sweep")
    data = make_folds(root, sizes=((1, 8),))
    cfg = ast_mod.ASTConfig(hidden_size=32, num_hidden_layers=2,
                            num_attention_heads=4, intermediate_size=64,
                            max_length=128)
    convert.save_hf_model_dir(ast_mod.init_params(
        np.random.default_rng(5), cfg), cfg, str(root / "pre"))
    sweep = root / "sweep.yaml"
    sweep.write_text(yaml.safe_dump({
        "method": "random",
        "metric": {"name": "eval_loss", "goal": "minimize"},
        "parameters": {
            "fold": {"values": [1]},
            "learning-rate": {"distribution": "log_uniform_values",
                              "min": 1e-4, "max": 1e-3},
            "label-smoothing": {"distribution": "uniform",
                                "min": 0.0, "max": 0.1},
            "focal-gamma": {"distribution": "uniform", "min": 0, "max": 2},
        },
    }))
    base = L.TrainFoldConfig(
        stage="stage1", data_dir=data, pretrained_model_dir=str(root / "pre"),
        num_epochs=2, batch_size=4, eval_batch_size=4, augment=False,
        enable_early_stopping=False, dtype=torch.float32, device="cpu")
    outs = {}
    for parallel in (False, True):
        out = root / ("par" if parallel else "seq")
        outs[parallel] = S.run_sweep(str(sweep), base, count=3, seed=5,
                                     output_dir=str(out),
                                     parallel_trials=parallel)
    return root, outs


def test_run_sweep_parallel_trials_matches_sequential(tree):
    """The same sampled parameters, in the same order, and the same
    objective values at 1e-4; each trial's run dir with its best model."""
    root, outs = tree
    seq = [json.loads(line) for line in
           (root / "seq" / "sweep_results.jsonl").read_text().splitlines()]
    par = [json.loads(line) for line in
           (root / "par" / "sweep_results.jsonl").read_text().splitlines()]
    assert len(seq) == len(par) == 3
    for s, p in zip(seq, par):
        assert s["params"] == p["params"] and s["fold"] == p["fold"] == 1
        assert p["value"] == pytest.approx(s["value"], abs=1e-4)
    best = json.loads((root / "par" / "best_config.json").read_text())
    assert best["value"] == min(p["value"] for p in par)
    assert outs[True]["best"]["trial"] == outs[False]["best"]["trial"]
    for t in range(3):
        assert (root / "par" / f"trial{t}" / "fold1" / "best" /
                "model.safetensors").exists()


def test_parallel_trials_need_one_fold(tmp_path):
    import yaml

    sweep = tmp_path / "s.yaml"
    sweep.write_text(yaml.safe_dump({"method": "random", "parameters": {
        "fold": {"values": [1, 2, 3, 4, 5]},
        "learning-rate": {"values": [1e-4, 2e-4]}}}))
    with pytest.raises(ValueError, match="single fold"):
        S.run_sweep(str(sweep), L.TrainFoldConfig(device="cpu"), count=6,
                    seed=0, output_dir=str(tmp_path / "o"),
                    parallel_trials=True)


def test_cli_parallel_trials_on_the_cpu(tree, tmp_path):
    """python -m ...cli.sweep --parallel-trials --device cpu in a fresh
    interpreter, from the repository root."""
    root, _ = tree
    out = tmp_path / "cli"
    proc = subprocess.run(
        [sys.executable, "-m", "zenker_audio_detection_tpu_torch.cli.sweep",
         str(root / "sweep.yaml"), "--stage", "stage1", "--count", "2",
         "--num-epochs", "1", "--batch-size", "4", "--no-augment", "--f32",
         "--data-dir", str(root / "data"), "--pretrained-model-dir",
         str(root / "pre"), "--parallel-trials", "--device", "cpu",
         "--output-dir", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Best trial" in proc.stdout
    assert (out / "best_config.json").exists()
    assert len((out / "sweep_results.jsonl").read_text().splitlines()) == 2


@pytest.mark.parametrize("flags,exc,match", [
    (["--num-devices", "2"], RuntimeError, "data_ast_stage1"),
    (["--parallel-trials", "--data-per-trial", "2"], SystemExit,
     "--data-per-trial requires an explicit --num-devices"),
    (["--data-per-trial", "1"], SystemExit,
     "--data-per-trial requires --parallel-trials"),
    (["--parallel-trials", "--streaming"], SystemExit, "incompatible"),
    (["--parallel-trials", "--grad-accum", "2"], SystemExit, "incompatible")])
def test_cli_refusals(tmp_path, monkeypatch, flags, exc, match):
    """The JAX agent's refusals with its words; --num-devices 2 now runs
    the agent on two ranks, whose first trial fails in each on the missing
    default data dir (reported by the launcher)."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(exc, match=match):
        cli.main([str(SWEEPS[0]), "--stage", "stage1", "--device", "cpu",
                  "--output-dir", str(tmp_path / "sw"), "--max-length",
                  "128", *flags])


def test_cli_without_device_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([str(SWEEPS[0]), "--stage", "stage1", "--output-dir",
                  str(tmp_path / "o"), "--parallel-trials"])
    assert not (tmp_path / "o").exists()


def test_trial_configs_carry_the_device(tmp_path, monkeypatch):
    """Every trial runs on the base config's device (the CLI's --device)."""
    seen = []
    monkeypatch.setattr(L, "train_fold", lambda fold, cfg: seen.append(
        cfg.device) or {f"fold{fold}_val_eval_f1": 0.5})
    S.run_sweep(str(SWEEPS[0]), dataclasses.replace(
        L.TrainFoldConfig(), device="cpu"), count=2,
        output_dir=str(tmp_path / "sw"))
    assert seen == ["cpu", "cpu"]
