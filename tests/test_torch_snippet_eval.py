"""The port's snippet evaluator (analysis/snippet_eval.py) and its CLIs
(cli/test_stage1.py, cli/test_stage2.py), with the confusion-matrix
plotter that reads their aggregate (cli/plot_confusion_matrices.py),
against the JAX package's on the same study: two folds per stage of tiny
random-init model directories written by JAX's `save_hf_model_dir`, the
fold splits, per-fold and aggregate stats JSONs and class_mapping.json.
Both run in f32 on the CPU; the port with device="cpu" / --device cpu.

Tolerances: the positive-class probabilities of every test clip within
1e-5 of JAX's; every row's probability lies more than that from the 0.5
argmax boundary (checked, and named if not), so the predictions, the
confusion matrices, classification_report.txt, the aggregate files and
the summary dicts are equal exactly."""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.analysis import roc_pr as jroc
from zenker_audio_detection_tpu.analysis import snippet_eval as jeval
from zenker_audio_detection_tpu.audio import io as jaio
from zenker_audio_detection_tpu.cli import plot_confusion_matrices as jplot
from zenker_audio_detection_tpu.cli import test_stage1 as jcli1
from zenker_audio_detection_tpu.cli import test_stage2 as jcli2
from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu.models import convert as jconvert
from zenker_audio_detection_tpu.train import loop as jtrain_loop
from zenker_audio_detection_tpu_torch.analysis import roc_pr
from zenker_audio_detection_tpu_torch.analysis import snippet_eval
from zenker_audio_detection_tpu_torch.cli import plot_confusion_matrices
from zenker_audio_detection_tpu_torch.cli import test_stage1, test_stage2
from zenker_audio_detection_tpu_torch.models import convert

PROB_TOL = 1e-5
FOLDS = (1, 2)
LABELS = {"stage1": {0: "Idle", 1: "Swallow"},
          "stage2": {0: "Healthy", 1: "Zenker"}}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """<root>/data_ast_<stage>/ (splits, stats, class mapping) and
    <root>/runs/ast_classifier_<stage>/fold<k>/best/ (JAX-written)."""
    root = tmp_path_factory.mktemp("snippet_study")
    cfg = jast.ASTConfig(hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=64,
                         max_length=128, num_labels=2)
    rng = np.random.default_rng(31)
    for si, stage in enumerate(("stage1", "stage2")):
        data = root / f"data_ast_{stage}"
        data.mkdir()
        (data / "class_mapping.json").write_text(json.dumps(
            {v: k for k, v in LABELS[stage].items()}))
        per_fold = []
        for fold in FOLDS:
            d = root / "runs" / f"ast_classifier_{stage}" / f"fold{fold}" \
                / "best"
            params = jax.tree.map(np.asarray, jast.init_params(
                jax.random.PRNGKey(20 + 10 * si + fold), cfg))
            head = params["head"]["dense"]
            head["kernel"] = np.random.default_rng(fold).standard_normal(
                head["kernel"].shape).astype(np.float32) * 0.1
            jconvert.save_hf_model_dir(params, cfg, str(d), LABELS[stage])
            jtrain_loop.save_feature_extractor_config(
                str(d), -1.15, 3.53, max_length=cfg.max_length)
            xs = []
            for i in range(12):
                p = root / "wav" / f"{stage}_{fold}_{i}.wav"
                p.parent.mkdir(parents=True, exist_ok=True)
                amp = float(rng.choice([0.005, 0.05, 0.3, 1.0]))
                jaio.write_wav(str(p), (rng.standard_normal(16000) * amp)
                               .astype(np.float32), 16000, dtype="float32")
                xs.append(str(p))
            np.save(data / f"test_x_fold{fold}.npy", np.asarray(xs))
            np.save(data / f"test_y_fold{fold}.npy", rng.integers(0, 2, 12))
            per_fold.append({"fold": fold, "mean": -1.0 - 0.3 * fold,
                             "std": 3.4 + 0.1 * fold, "count": 1200})
        (data / "stats_per_fold.json").write_text(json.dumps(per_fold))
        (data / "stats_aggregate.json").write_text(json.dumps(
            {"mean": -1.4, "std": 3.6, "total_count": 2400}))
    return root


def _copy_runs(study, dst):
    shutil.copytree(study / "runs", dst)
    return dst


def _tree(root):
    """{relative path: contents} of every file under root (.npy as lists
    with their dtype)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            rel = os.path.relpath(p, root)
            if name.endswith(".npy"):
                a = np.load(p, allow_pickle=True)
                out[rel] = (str(a.dtype), a.tolist())
            elif name.endswith((".txt", ".json")):
                with open(p) as f:
                    out[rel] = f.read()
    return out


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_probabilities_within_tolerance(study, stage):
    """Every test clip's softmax[:, 1] within PROB_TOL of JAX's, and every
    row more than PROB_TOL from the argmax boundary."""
    data = str(study / f"data_ast_{stage}")
    for fold in FOLDS:
        best = str(study / "runs" / f"ast_classifier_{stage}"
                   / f"fold{fold}" / "best")
        paths = np.load(os.path.join(data, f"test_x_fold{fold}.npy")).tolist()
        mean, std = snippet_eval.load_mean_std(data, fold, False)
        assert (mean, std) == jeval.load_mean_std(data, fold, False)
        params, cfg = convert.load_hf_model_dir(best)
        got = roc_pr.positive_scores_from_params(
            params, cfg, mean, std, paths, batch_size=5,
            dtype=torch.float32, device="cpu")
        jparams, jcfg = jconvert.load_hf_model_dir(best)
        want = jroc.positive_scores_from_params(
            jparams, jcfg, mean, std, paths, batch_size=5,
            dtype=jnp.float32)
        np.testing.assert_allclose(got, want, atol=PROB_TOL, rtol=0)
        margin = np.abs(want - 0.5).min()
        assert margin > PROB_TOL, (
            f"{stage} fold {fold}: a probability lies {margin:.2e} from "
            f"0.5, under the tolerance {PROB_TOL}; its argmax may differ "
            f"between the packages")
        assert 0 < (want > 0.5).sum() < len(want)


@pytest.mark.parametrize("use_aggregate", [False, True])
@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_evaluate_all_folds_equals_jax(study, tmp_path, capsys, stage,
                                       use_aggregate):
    data = str(study / f"data_ast_{stage}")
    kw = dict(stage=stage, data_dir=data, folds=list(FOLDS),
              use_aggregate_stats=use_aggregate, batch_size=5)
    ours_root = _copy_runs(study, tmp_path / "ours")
    theirs_root = _copy_runs(study, tmp_path / "jax")
    got = snippet_eval.evaluate_all_folds(
        model_root=str(ours_root / f"ast_classifier_{stage}"),
        central_results_dir=str(tmp_path / "ours_central"),
        dtype=torch.float32, device="cpu", **kw)
    out_ours = capsys.readouterr().out
    want = jeval.evaluate_all_folds(
        model_root=str(theirs_root / f"ast_classifier_{stage}"),
        central_results_dir=str(tmp_path / "jax_central"),
        dtype=jnp.float32, **kw)
    assert capsys.readouterr().out == out_ours
    assert json.dumps(got) == json.dumps(want)
    assert _tree(ours_root) == _tree(theirs_root)
    assert _tree(tmp_path / "ours_central") == _tree(tmp_path / "jax_central")
    agg = ours_root / f"ast_classifier_{stage}" / "cv_aggregate_evaluation"
    folds_sum = sum(np.load(ours_root / f"ast_classifier_{stage}"
                            / f"fold{k}" / "best" / "evaluation"
                            / "confusion_matrix.npy") for k in FOLDS)
    np.testing.assert_array_equal(np.load(agg / "confusion_matrix.npy"),
                                  folds_sum)


@pytest.mark.parametrize("mod,jmod,stage", [
    (test_stage1, jcli1, "stage1"), (test_stage2, jcli2, "stage2")])
@pytest.mark.parametrize("fold_args", [["--all"], ["--fold", "2"]])
def test_cli_equals_jax(study, tmp_path, monkeypatch, mod, jmod, stage,
                        fold_args):
    """The CLIs with the JAX flags (--f32, --num-folds, --data-dir,
    --model-root, --results-dir, --mapping-path) from a working directory
    of their own; the port with --device cpu."""
    for name, m, extra in (("ours", mod, ["--device", "cpu"]),
                           ("jax", jmod, [])):
        work = tmp_path / name
        work.mkdir()
        _copy_runs(study, work / "runs")
        monkeypatch.chdir(work)
        m.main([*fold_args, "--num-folds", "2", "--f32",
                "--batch-size", "4",
                "--data-dir", str(study / f"data_ast_{stage}"),
                "--model-root", f"runs/ast_classifier_{stage}",
                "--mapping-path",
                str(study / f"data_ast_{stage}" / "class_mapping.json"),
                *extra])
    assert _tree(tmp_path / "ours") == _tree(tmp_path / "jax")
    central = tmp_path / "ours" / "results" / stage
    assert (central / "fold2_classification_report.txt").exists()
    assert (central / "aggregate_classification_report.txt").exists() == \
        (fold_args == ["--all"])


def test_cli_refuses_fold_zero(study):
    with pytest.raises(SystemExit, match="--fold must be in"):
        test_stage1.main(["--fold", "0", "--device", "cpu"])


def test_plot_confusion_matrices_equals_jax(study, tmp_path, capsys):
    """cli.plot_confusion_matrices reads the evaluators' summed matrices
    (cv_aggregate_evaluation) and prints the same derived statistics as the
    JAX CLI, with the same figures."""
    pytest.importorskip("matplotlib")
    root = _copy_runs(study, tmp_path / "runs")
    for stage in ("stage1", "stage2"):
        snippet_eval.evaluate_all_folds(
            stage=stage, data_dir=str(study / f"data_ast_{stage}"),
            model_root=str(root / f"ast_classifier_{stage}"),
            central_results_dir=str(tmp_path / "central"),
            folds=list(FOLDS), batch_size=6, dtype=torch.float32,
            device="cpu")
    capsys.readouterr()
    plot_confusion_matrices.main(["--model-root", str(root),
                                  "--output-dir", str(tmp_path / "ours")])
    ours = capsys.readouterr().out
    jplot.main(["--model-root", str(root),
                "--output-dir", str(tmp_path / "jax")])
    assert capsys.readouterr().out.replace(str(tmp_path / "jax"), "OUT") \
        == ours.replace(str(tmp_path / "ours"), "OUT")
    assert sorted(os.listdir(tmp_path / "ours")) == \
        sorted(os.listdir(tmp_path / "jax"))
    assert "hardcoded" not in ours.lower()
