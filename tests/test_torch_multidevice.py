"""Training and serving over several devices against the JAX package:
`train_fold` with `num_devices`, fold- and trial-parallel training with
the fold (trial) axis over ranks and fold x data groups, and the CLIs with
`--num-devices`, `--num-slices`, `--data-per-fold` and `--data-per-trial`,
mirroring tests/test_multichip.py:178-306, :384,
tests/test_fold_parallel.py:120-187, :327 and
tests/test_trial_parallel.py:120-168, :259.

The port runs two ranks (four for the ("dcn", "data") and fold x data
meshes) of a gloo process group on the CPU, started by
`parallel/launch.spawn` (the CLIs start their own), one intra-op thread
each; the ranks run `parallel/checks.py` and start from the JAX package's
`init_params` tree (its `init_model` replaced in each rank, as
tests/test_torch_train_loop.py replaces it in one process). The JAX side
runs here, on one device. Tolerances: the loop's metrics and histories
1e-4, as the port's single-device loop is held to JAX's
(tests/test_torch_train_loop.py; the JAX mesh tests hold their own mesh
to 1e-5 and 1e-4); within the port, every rank returns the same metrics,
and two ranks equal one device at 1e-5; the CLIs' JSONs 1e-6 with every
decision equal (test_multichip.py:232)."""

import json
import os

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.train import loop as JL
from zenker_audio_detection_tpu_torch.cli import infer_long_audio
from zenker_audio_detection_tpu_torch.cli import run_all_folds
from zenker_audio_detection_tpu_torch.cli import run_batch_2stage
from zenker_audio_detection_tpu_torch.cli import sweep as cli_sweep
from zenker_audio_detection_tpu_torch.cli import train_stage1
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.parallel import checks, launch
from zenker_audio_detection_tpu_torch.train import loop as L

from test_multichip import _assert_json_close, product_tree  # noqa: F401
from test_torch_fold_parallel import TINY, _jax_tree, _patch_init, make_folds
from test_torch_trial_parallel import TRIALS

TOL = 1e-4
SAME = 1e-5
COMMON = dict(stage="stage1", num_epochs=3, batch_size=4, eval_batch_size=4,
              learning_rate=1e-3, warmup_ratio=0.25,
              enable_early_stopping=True, augment=False, seed=42)
SWEEP_YAML = """method: random
metric:
  name: eval_f1
  goal: maximize
parameters:
  learning-rate:
    values: [0.001, 0.0003]
  fold:
    value: 1
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _speed(key: str) -> bool:
    return "runtime" in key or "per_second" in key


def _close(got: dict, want: dict, tol: float) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        if not _speed(k):
            assert got[k] == pytest.approx(v, abs=tol), (k, got[k], v)


def _history(root, tag, fold=1):
    return json.loads((root / tag / f"fold{fold}" / "history.json")
                      .read_text())


def _same_histories(root, got_tag, want_tag, folds=(1, 2), tol=TOL):
    for fold in folds:
        got = _history(root, got_tag, fold)
        want = _history(root, want_tag, fold)
        assert [h["epoch"] for h in got] == [h["epoch"] for h in want]
        for g, w in zip(got, want):
            for key in ("loss", "f1", "accuracy"):
                assert g[key] == pytest.approx(w[key], abs=tol), (fold, g, w)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Two folds of unequal train sizes (10 and 13 clips at batch 4) and
    the JAX package's sequential runs of both, and its trial-parallel run
    of two trials, from one parameter tree."""
    import jax.numpy as jnp
    from zenker_audio_detection_tpu.train.trial_parallel import (
        train_trials_parallel as jax_trials)

    root = tmp_path_factory.mktemp("md")
    data = make_folds(root)
    jtree = _jax_tree()
    with pytest.MonkeyPatch.context() as mp:
        _patch_init(mp, jtree)
        seq = [JL.train_fold(f, JL.TrainFoldConfig(
            data_dir=data, output_root=str(root / "jax_seq"),
            dtype=jnp.float32, **COMMON)) for f in (1, 2)]
        trials = jax_trials(1, _trial_cfgs(
            lambda **kw: JL.TrainFoldConfig(dtype=jnp.float32, **kw),
            root, data, "jax_tr"))
    return root, data, jtree, seq, trials


def _trial_cfgs(make, root, data, tag, **kw):
    return [make(data_dir=data, output_root=str(root / f"{tag}_t{i}"),
                 **{**COMMON, **trial, **kw})
            for i, trial in enumerate(TRIALS[:2])]


def pretrained(tree) -> str:
    """The tree of the runs above as an HF directory (hidden 32, 128
    frames), for the CLIs."""
    from zenker_audio_detection_tpu_torch.models import convert

    root, _, jtree, _, _ = tree
    pre = root / "pretrained"
    if not pre.exists():
        convert.save_hf_model_dir(convert.params_from_jax(jtree),
                                  ast_mod.ASTConfig(**TINY), str(pre))
    return str(pre)


def _port_cfg(root, data, tag, **kw):
    return L.TrainFoldConfig(data_dir=data, output_root=str(root / tag),
                             dtype=torch.float32, device="cpu",
                             **{**COMMON, **kw})


@pytest.fixture(scope="module")
def two_ranks(tree):
    """The training checks of two ranks, in one process group."""
    root, data, jtree, _, _ = tree
    init = (jtree, ast_mod.ASTConfig(**TINY))
    calls = {
        "fold": ("train_fold", (1, _port_cfg(
            root, data, "dp2", num_devices=2, eval_batch_size=3)),
            {"init": init}),
        "folds": ("train_folds_parallel", ([1, 2], _port_cfg(
            root, data, "fp2", num_devices=2)), {"init": init}),
        "trials": ("train_trials_parallel", (1, _trial_cfgs(
            lambda **kw: L.TrainFoldConfig(dtype=torch.float32, device="cpu",
                                           **kw),
            root, data, "tp2", num_devices=2)), {"init": init}),
    }
    out = launch.spawn(checks.sequence, (list(calls.values()),), nprocs=2,
                       device="cpu")
    return dict(zip(calls, out))


@pytest.fixture(scope="module")
def four_ranks(tree):
    """The fold x data and trial x data groups: two groups of two ranks."""
    root, data, jtree, _, _ = tree
    init = (jtree, ast_mod.ASTConfig(**TINY))
    calls = {
        "folds": ("train_folds_parallel", ([1, 2], _port_cfg(
            root, data, "fd4", num_devices=4, data_per_fold=2,
            eval_batch_size=3)), {"init": init}),
        "trials": ("train_trials_parallel", (1, _trial_cfgs(
            lambda **kw: L.TrainFoldConfig(dtype=torch.float32, device="cpu",
                                           **kw),
            root, data, "td4", num_devices=4, data_per_fold=2)),
            {"init": init}),
    }
    out = launch.spawn(checks.sequence, (list(calls.values()),), nprocs=4,
                       device="cpu")
    return dict(zip(calls, out))


def _ranks(entry):
    """Rank 0's result of a gathered check; every rank's equals it (the
    ranks took the same branches), speed metrics aside."""
    status, value = entry
    assert status == "ok", value
    first = value[0]
    for other in value[1:]:
        pairs = (zip(other, first) if isinstance(first, list)
                 else [(other, first)])
        for a, b in pairs:
            _close(a, b, 0.0)
    return first


# ---------------------------------------------------------------------------
# train_fold over two ranks (tests/test_multichip.py:178, :188, :211)
# ---------------------------------------------------------------------------


def test_train_fold_mesh_matches_jax(tree, two_ranks, capfd):
    """train_fold(num_devices=2) against the JAX package's single-device
    train_fold from the same tree: metrics and per-epoch history."""
    root, _, _, seq, _ = tree
    got = _ranks(two_ranks["fold"])
    _close(got, seq[0], TOL)
    _same_histories(root, "dp2", "jax_seq", folds=(1,))


def test_train_fold_mesh_matches_one_device(tree, two_ranks):
    """Within the port: two ranks against one device, 1e-5."""
    root, data, jtree, _, _ = tree
    with pytest.MonkeyPatch.context() as mp:
        _patch_init(mp, jtree)
        one = L.train_fold(1, _port_cfg(root, data, "dp1"))
    _close(_ranks(two_ranks["fold"]), one, SAME)
    _same_histories(root, "dp2", "dp1", folds=(1,), tol=SAME)


def test_train_fold_rejects_indivisible_batch(tmp_path):
    """batch_size % num_devices != 0 is refused before any run-dir side
    effect and before any process group is needed (JAX's words)."""
    out = tmp_path / "runs"
    cfg = L.TrainFoldConfig(data_dir=str(tmp_path), output_root=str(out),
                            batch_size=10, num_devices=4, device="cpu")
    with pytest.raises(ValueError, match="not divisible by the 4-device"):
        L.train_fold(1, cfg)
    assert not out.exists()


def test_train_fold_eval_batch_rounds_up_to_mesh(tree, two_ranks):
    """eval_batch_size 3 over two ranks rounds up to 4 (JAX's policy);
    the run above used it and its metrics hold."""
    root = tree[0]
    got = _ranks(two_ranks["fold"])
    assert all(np.isfinite(v) for v in got.values())
    assert (root / "dp2" / "fold1" / "best" / "model.safetensors").exists()


def test_train_fold_writes_once(tree, two_ranks):
    """The first rank writes the fold's files: one checkpoint per epoch
    (save_total_limit 2), one best export, no staging dir left."""
    fold_dir = tree[0] / "dp2" / "fold1"
    names = sorted(os.listdir(fold_dir))
    assert not [n for n in names if n.endswith(".tmp")]
    assert len([n for n in names if n.startswith("checkpoint-")]) == 2


# ---------------------------------------------------------------------------
# fold- and trial-parallel over ranks (tests/test_fold_parallel.py:120,
# :134, :175 and tests/test_trial_parallel.py:120, :137, :156)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ranks,tag", [("two", "fp2"), ("four", "fd4")])
def test_folds_over_ranks_match_jax_sequential(tree, two_ranks, four_ranks,
                                               ranks, tag):
    """Two folds over two ranks (one fold each) and over two groups of two
    ranks (each fold's rows over its group): each fold's metrics and
    history are the JAX sequential trainer's."""
    root, _, _, seq, _ = tree
    got = _ranks((two_ranks if ranks == "two" else four_ranks)["folds"])
    assert len(got) == 2
    for g, w in zip(got, seq):
        _close(g, w, TOL)
    _same_histories(root, tag, "jax_seq")


@pytest.mark.parametrize("ranks,tag", [("two", "tp2"), ("four", "td4")])
def test_trials_over_ranks_match_jax(tree, two_ranks, four_ranks, ranks,
                                     tag):
    """Two trials over two ranks and over two groups of two ranks: each
    trial's metrics and history are JAX's trial-parallel run's."""
    root, _, _, _, want = tree
    got = _ranks((two_ranks if ranks == "two" else four_ranks)["trials"])
    assert len(got) == len(want) == 2
    for t, (g, w) in enumerate(zip(got, want)):
        _close(g, w, TOL)
        a = json.loads((root / f"{tag}_t{t}" / "fold1" / "history.json")
                       .read_text())
        b = json.loads((root / f"jax_tr_t{t}" / "fold1" / "history.json")
                       .read_text())
        assert [h["epoch"] for h in a] == [h["epoch"] for h in b]
        for x, y in zip(a, b):
            for key in ("loss", "f1", "accuracy"):
                assert x[key] == pytest.approx(y[key], abs=TOL)


@pytest.mark.parametrize("kw,match", [
    ({"data_per_fold": 2}, "requires num_devices"),
    ({"num_devices": 3, "data_per_fold": 2}, "not divisible into groups"),
    ({"num_devices": 6, "data_per_fold": 3}, "batch_size 4 not divisible"),
    ({"num_devices": 4, "data_per_fold": 2, "folds": [1, 2, 3]},
     "folds not divisible"),
    ({"num_devices": 2, "num_slices": 2}, "--num-slices is not supported")])
def test_fold_group_validation(tmp_path, kw, match):
    """JAX's validations (test_fold_parallel.py:175-187), before any run
    dir is touched."""
    from zenker_audio_detection_tpu_torch.train import fold_parallel

    folds = kw.pop("folds", [1, 2])
    cfg = L.TrainFoldConfig(output_root=str(tmp_path / "out"), device="cpu",
                            batch_size=4, fold_parallel=True, **kw)
    with pytest.raises(ValueError, match=match):
        fold_parallel.train_folds_parallel(folds, cfg)
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("kw,match", [
    ({"num_devices": 4, "data_per_fold": 2}, "not divisible by 2 trial "
                                             "groups"),
    ({"data_per_fold": 2}, "requires num_devices"),
    ({"num_devices": 3, "data_per_fold": 3}, "batch_size 4 not divisible")])
def test_trial_group_validation(tmp_path, kw, match):
    """JAX's validations (test_trial_parallel.py:156-168): three trials."""
    from zenker_audio_detection_tpu_torch.train import trial_parallel

    cfgs = [L.TrainFoldConfig(output_root=str(tmp_path / f"t{i}"),
                              device="cpu", batch_size=4, **trial, **kw)
            for i, trial in enumerate(TRIALS)]
    with pytest.raises(ValueError, match=match):
        trial_parallel.train_trials_parallel(1, cfgs)


# ---------------------------------------------------------------------------
# the CLIs (tests/test_multichip.py:251, :273, :384;
# tests/test_fold_parallel.py:327; tests/test_trial_parallel.py:259)
# ---------------------------------------------------------------------------


def _infer_argv(root, out, *extra):
    return ["--stage1-model-root",
            str(root / "runs/ast_classifier_stage1/fold1/best"),
            "--stage2-model-root",
            str(root / "runs/ast_classifier_stage2/fold1/best"),
            "--patient-id", "ZP0", "--long-audio-root", str(root / "Long"),
            "--output-json", str(out), "--f32", "--disable-cache",
            "--batch-size", "16", *extra]


@pytest.fixture(scope="module")
def jax_infer(product_tree):
    """JAX's single-device infer_long_audio JSON on the product tree."""
    from zenker_audio_detection_tpu.cli import infer_long_audio as jcli

    out = product_tree / "jax_single.json"
    jcli.main(_infer_argv(product_tree, out))
    return json.loads(out.read_text())


@pytest.mark.parametrize("extra", [["--num-devices", "2"],
                                   ["--num-devices", "4", "--num-slices",
                                    "2"]])
def test_infer_cli_num_devices_matches_jax(product_tree, jax_infer, extra):
    out = product_tree / f"port_{'_'.join(extra)}.json"
    infer_long_audio.main(_infer_argv(product_tree, out, "--device", "cpu",
                                      "--attention-impl", "torch", *extra))
    got = json.loads(out.read_text())
    _assert_json_close(jax_infer["aggregate"], got["aggregate"])
    _assert_json_close(jax_infer["per_file"], got["per_file"])


def test_infer_cli_under_torchrun_matches_jax(product_tree, jax_infer):
    """Under torchrun (two gloo ranks on the CPU, its own rendezvous on a
    free local port) the CLI joins torchrun's group, runs in place and
    gives JAX's JSON."""
    import subprocess
    import sys

    out = product_tree / "port_torchrun.json"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m",
         "zenker_audio_detection_tpu_torch.cli.infer_long_audio",
         *_infer_argv(product_tree, out, "--device", "cpu",
                      "--attention-impl", "torch", "--num-devices", "2")],
        cwd=repo, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(out.read_text())
    _assert_json_close(jax_infer["aggregate"], got["aggregate"])
    _assert_json_close(jax_infer["per_file"], got["per_file"])


def test_batch_driver_num_devices_matches_jax(product_tree):
    """run_batch_2stage --num-devices 2 against JAX's single-device
    driver: per-patient JSONs equal (ids file, thresholds, skip logic)."""
    from zenker_audio_detection_tpu.cli import run_batch_2stage as jbatch

    ids_root = product_tree / "ids_port"
    ids_root.mkdir(exist_ok=True)
    (ids_root / "test_ids_fold1.txt").write_text("Long/Zenker/ZP0\n")
    common = ["--fold", "1", "--ids-root", str(ids_root),
              "--long-audio-root", str(product_tree / "Long"),
              "--model-root", str(product_tree / "runs"),
              "--batch-size", "16", "--f32", "--disable-cache"]
    jbatch.main(common + ["--output-dir", str(product_tree / "jb")])
    run_batch_2stage.main(common + [
        "--output-dir", str(product_tree / "pb"), "--device", "cpu",
        "--attention-impl", "torch", "--num-devices", "2"])
    want = json.loads((product_tree / "jb" / "ZP0_2stage.json").read_text())
    got = json.loads((product_tree / "pb" / "ZP0_2stage.json").read_text())
    _assert_json_close(want["per_file"], got["per_file"])
    _assert_json_close(want["aggregate"], got["aggregate"])


def test_run_all_folds_data_per_fold_matches_jax(product_tree):
    """run_all_folds --parallel-folds --data-per-fold 2: fold 1's engine on
    a group of two ranks; its patient JSON equals JAX's single-device
    batch driver's, and the aggregate runs once."""
    from zenker_audio_detection_tpu.cli import run_batch_2stage as jbatch

    ids_root = product_tree / "ids_all"
    ids_root.mkdir(exist_ok=True)
    (ids_root / "test_ids_fold1.txt").write_text("Long/Zenker/ZP0\n")
    jbatch.main(["--fold", "1", "--ids-root", str(ids_root),
                 "--long-audio-root", str(product_tree / "Long"),
                 "--model-root", str(product_tree / "runs"),
                 "--f32", "--disable-cache",
                 "--output-dir", str(product_tree / "ja")])
    out = product_tree / "pa"
    run_all_folds.main([str(product_tree / "runs"), "--long-audio-root",
                        str(product_tree / "Long"), "--ids-root",
                        str(ids_root), "--num-folds", "1", "--output-dir",
                        str(out), "--no-threshold-config", "--f32",
                        "--device", "cpu", "--parallel-folds",
                        "--data-per-fold", "2", "--aggregate"])
    want = json.loads((product_tree / "ja" / "ZP0_2stage.json").read_text())
    got = json.loads((out / "ZP0_2stage.json").read_text())
    _assert_json_close(want["per_file"], got["per_file"])
    assert (out / "aggregate_summary.json").exists()


@pytest.mark.parametrize("flags,tag", [
    (["--num-devices", "2", "--fold", "1"], "cli_dp"),
    (["--parallel-folds", "--num-devices", "2"], "cli_fp")])
def test_train_cli_num_devices(tree, flags, tag):
    """train_stage1 with --num-devices 2, data-parallel and with the fold
    axis over the ranks: the standard cv artifacts, written once."""
    root, data, _, _, _ = tree
    out = root / tag
    train_stage1.main(["--num-folds", "2", "--num-epochs", "1",
                       "--batch-size", "4", "--learning-rate", "1e-3",
                       "--f32", "--no-early-stopping", "--no-augment",
                       "--data-dir", data, "--output-root", str(out),
                       "--no-wandb", "--device", "cpu",
                       "--pretrained-model-dir", pretrained(tree), *flags])
    folds = (1,) if "--fold" in flags else (1, 2)
    cv = np.load(out / "cv_metrics.npy", allow_pickle=True).item()
    assert len(cv["per_fold"]) == len(folds)
    assert len(list(out.glob("run_config_*.json"))) == 1
    for f in folds:
        assert (out / f"fold{f}" / "best" / "model.safetensors").exists()
        assert (out / f"fold{f}" / "run_config.json").exists()


def test_sweep_cli_parallel_trials_over_ranks(tree, tmp_path):
    """cli.sweep --parallel-trials --num-devices 2: two trials, one per
    rank; one results file with both trials and the best config."""
    root, data, _, _, _ = tree
    yaml_path = tmp_path / "sweep.yaml"
    yaml_path.write_text(SWEEP_YAML)
    out = tmp_path / "sw"
    cli_sweep.main([str(yaml_path), "--stage", "stage1", "--count", "2",
                    "--num-epochs", "1", "--batch-size", "4", "--no-augment",
                    "--f32", "--data-dir", data, "--pretrained-model-dir",
                    pretrained(tree), "--parallel-trials", "--num-devices",
                    "2",
                    "--device", "cpu", "--output-dir", str(out)])
    lines = (out / "sweep_results.jsonl").read_text().splitlines()
    assert len(lines) == 2
    assert (out / "best_config.json").exists()
