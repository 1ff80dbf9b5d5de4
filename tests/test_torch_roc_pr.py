"""The port's ROC/PR analysis (analysis/roc_pr.py, cli/analyze_roc_pr.py,
cli/extract_thresholds.py) and the numpy ranking metrics it runs on
(train/metrics.py) against sklearn and the JAX package.

Tolerances:
- `roc_curve`, `precision_recall_curve`, `roc_auc_score` and
  `average_precision_score` against sklearn: exact (arrays equal with
  their dtypes, scores equal), on random and heavily tied scores in f32
  and f64; the output_dict report and the confusion matrix: exact.
- `_curve_metrics` and `bootstrap_ci` against the JAX functions on the
  same scores: exact.
- `analyze(...)`'s payload against JAX's on JAX-written model directories,
  f32 on the CPU: every float within 1e-5 (the two forwards' scores differ
  by ~1e-7); the fpr/tpr and precision/recall lists and the confusion
  lists equal (the score order is the same: the test checks that no two
  scores lie within 1e-5 of each other, and says so if they do). The
  payloads and `_curve_metrics` run both packages' bootstrap at 100 draws
  instead of 2000 (sklearn's metrics take ~4 ms a call); the analyzer's
  2000 draws are held to JAX's in `test_bootstrap_ci_equals_jax`."""

import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import sklearn.metrics as skm
import torch

from zenker_audio_detection_tpu.analysis import roc_pr as jroc
from zenker_audio_detection_tpu.audio import io as jaio
from zenker_audio_detection_tpu.cli import extract_thresholds as jextract
from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu.models import convert as jconvert
from zenker_audio_detection_tpu.train import loop as jtrain_loop
from zenker_audio_detection_tpu_torch.analysis import roc_pr
from zenker_audio_detection_tpu_torch.cli import analyze_roc_pr
from zenker_audio_detection_tpu_torch.cli import extract_thresholds
from zenker_audio_detection_tpu_torch.train import metrics as M

SCORE_TOL = 1e-5
FOLDS = (1, 2)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the numpy ranking metrics against sklearn
# ---------------------------------------------------------------------------


def _scored(kind: str, n: int, dtype, seed: int):
    r = np.random.default_rng(seed)
    y = r.integers(0, 2, n)
    if kind == "random":
        s = np.clip(0.5 * y + r.standard_normal(n) * 0.4, -1, 2)
    elif kind == "tied":  # a handful of distinct values
        s = r.integers(0, 5, n) / 4.0
    elif kind == "rounded":  # ties mixed with distinct values
        s = np.round(r.random(n) + 0.2 * y, 1)
    else:  # imbalanced: a few positives
        y = (r.random(n) < 0.08).astype(int)
        y[0] = 1
        s = r.random(n) + 0.3 * y
    return y, s.astype(dtype)


GRID = [(kind, n, dtype)
        for kind in ("random", "tied", "rounded", "imbalanced")
        for n in (5, 60, 700) for dtype in (np.float32, np.float64)]


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind,n,dtype", GRID,
                         ids=[f"{k}-{n}-{np.dtype(d).name}"
                              for k, n, d in GRID])
def test_curves_equal_sklearn(kind, n, dtype):
    for seed in range(5):
        y, s = _scored(kind, n, dtype, seed)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            want_roc = skm.roc_curve(y, s)
            want_pr = skm.precision_recall_curve(y, s)
            want_auc = skm.roc_auc_score(y, s)
            want_ap = skm.average_precision_score(y, s)
            got_roc, got_pr = M.roc_curve(y, s), M.precision_recall_curve(y, s)
            got_auc = M.roc_auc_score(y, s)
            got_ap = M.average_precision_score(y, s)
        for g, w in zip(got_roc + got_pr, want_roc + want_pr):
            _same(g, w)
        assert got_roc[2][0] == np.inf
        assert got_pr[2].dtype == np.dtype(dtype)
        assert got_auc == want_auc or (np.isnan(got_auc)
                                       and np.isnan(want_auc))
        assert got_ap == want_ap
        pred = (s >= 0.5).astype(int)
        _same(M.confusion_matrix(y, pred, [0, 1]),
              skm.confusion_matrix(y, pred, labels=[0, 1]))
        assert M.report_dict(y, pred, ["Neg", "Pos"]) == \
            skm.classification_report(y, pred, target_names=["Neg", "Pos"],
                                      output_dict=True, zero_division=0)


@pytest.mark.parametrize("y", [[1, 1, 1], [0, 0, 0, 0]])
def test_one_class_as_sklearn(y):
    """One class present: sklearn 1.9 warns and returns nan for the ROC AUC
    (it does not raise), and average precision is 1 or 0 (with a warning
    when there is no positive)."""
    s = np.linspace(0.1, 0.9, len(y))
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = (M.roc_auc_score(y, s), M.average_precision_score(y, s))
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = (skm.roc_auc_score(y, s), skm.average_precision_score(y, s))
    assert np.isnan(got[0]) and np.isnan(want[0])
    assert got[1] == want[1]
    assert [str(w.message) for w in got_w] == [str(w.message)
                                               for w in want_w]
    for g, w in zip(M.roc_curve(y, s), skm.roc_curve(y, s)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fn", ["roc_auc_score", "average_precision_score",
                                "roc_curve", "precision_recall_curve"])
@pytest.mark.parametrize("case", ["three_classes", "nan_score",
                                  "lengths", "strings"])
def test_refusals_as_sklearn(fn, case):
    y, s = [0, 1, 1, 0], [0.1, 0.4, 0.35, 0.8]
    if case == "three_classes":
        y = [0, 1, 2, 0]
    elif case == "nan_score":
        s = [0.1, np.nan, 0.35, 0.8]
    elif case == "lengths":
        s = s[:3]
    else:
        y = ["a", "b", "b", "a"]
    y, s = np.asarray(y), np.asarray(s)
    if case == "strings" and fn == "roc_auc_score":
        # the larger label is the positive one: no pos_label is needed
        assert M.roc_auc_score(y, s) == skm.roc_auc_score(y, s)
        return
    with pytest.raises(ValueError):
        getattr(skm, fn)(y, s)
    with pytest.raises(ValueError):
        getattr(M, fn)(y, s)


# ---------------------------------------------------------------------------
# _curve_metrics and bootstrap_ci against the JAX functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "tied", "imbalanced"])
def test_curve_metrics_equal_jax(kind, few_draws):
    y, s = _scored(kind, 150, np.float32, 3)
    names = ["Idle", "Swallow"]
    got = roc_pr._curve_metrics(y, s, names, (0.3, 0.5))
    want = jroc._curve_metrics(y, s, names, (0.3, 0.5))
    assert json.dumps(got) == json.dumps(want)


def test_bootstrap_ci_equals_jax():
    y, s = _scored("rounded", 40, np.float64, 9)
    # the analyzer's call: 2000 draws, seed 42 (explicit: the few_draws
    # fixture may have lowered the defaults of both functions)
    assert roc_pr.bootstrap_ci(y, s, M.roc_auc_score, 2000, 42) == \
        jroc.bootstrap_ci(y, s, skm.roc_auc_score, 2000, 42)
    got = roc_pr.bootstrap_ci(y, s, M.average_precision_score,
                              n_bootstrap=300, seed=7)
    assert got == jroc.bootstrap_ci(y, s, skm.average_precision_score,
                                    n_bootstrap=300, seed=7)
    # the skip of one-class draws and the swallowed errors keep the draw
    # sequence: a metric that raises on some draws gives the same CI
    calls = []

    def flaky(yt, ys):
        calls.append(1)
        if len(calls) % 3 == 0:
            raise ValueError("flaky")
        return float(np.mean(ys[yt == 1]))

    got = roc_pr.bootstrap_ci(y, s, flaky, n_bootstrap=200)
    calls.clear()
    assert got == jroc.bootstrap_ci(y, s, flaky, n_bootstrap=200)


def test_load_split_val_fallback(tmp_path):
    np.save(tmp_path / "test_x_fold1.npy", np.asarray(["a.wav"], object))
    np.save(tmp_path / "test_y_fold1.npy", np.asarray([1]))
    assert roc_pr.load_split(str(tmp_path), 1, "val") == \
        jroc.load_split(str(tmp_path), 1, "val") == (["a.wav"], [1], "test")
    with pytest.raises(FileNotFoundError):
        roc_pr.load_split(str(tmp_path), 2, "val")


# ---------------------------------------------------------------------------
# the analyzer against JAX's on JAX-written model directories
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    """Per stage: fold{1,2}/best directories written by the JAX package
    (random heads, so the scores spread), a val split for fold 1 and a
    test split only for fold 2 (the fallback)."""
    root = tmp_path_factory.mktemp("rocpr_study")
    cfg = jast.ASTConfig(hidden_size=32, num_hidden_layers=1,
                         num_attention_heads=2, intermediate_size=64,
                         max_length=128, num_labels=2)
    rng = np.random.default_rng(21)
    for si, (stage, labels) in enumerate((
            ("stage1", {0: "Idle", 1: "Swallow"}),
            ("stage2", {0: "Healthy", 1: "Zenker"}))):
        data = root / f"data_{stage}"
        data.mkdir()
        for fold in FOLDS:
            d = root / "runs" / stage / f"fold{fold}" / "best"
            params = jax.tree.map(np.asarray, jast.init_params(
                jax.random.PRNGKey(10 * si + fold), cfg))
            head = params["head"]["dense"]
            head["kernel"] = np.random.default_rng(fold).standard_normal(
                head["kernel"].shape).astype(np.float32) * 0.1
            jconvert.save_hf_model_dir(params, cfg, str(d), labels)
            jtrain_loop.save_feature_extractor_config(
                str(d), -1.15, 3.53, max_length=cfg.max_length)
            xs, ys = [], []
            for i in range(14):
                label = i % 2
                p = root / "wav" / f"{stage}_{fold}_{i}.wav"
                p.parent.mkdir(parents=True, exist_ok=True)
                amp = float(rng.choice([0.01, 0.1, 0.5])) * (1 + label)
                jaio.write_wav(str(p), (rng.standard_normal(16000) * amp)
                               .astype(np.float32), 16000, dtype="float32")
                xs.append(str(p))
                ys.append(label)
            split = "val" if fold == 1 else "test"
            np.save(data / f"{split}_x_fold{fold}.npy",
                    np.asarray(xs, object))
            np.save(data / f"{split}_y_fold{fold}.npy", np.asarray(ys))
    return root


def _close(got, want, path="payload"):
    """Floats within SCORE_TOL, everything else equal, recursively."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), path
        assert got == want or abs(got - want) <= SCORE_TOL, (path, got,
                                                             want)
    else:
        assert got == want, (path, got, want)


BOOTSTRAP_DRAWS = 100


@pytest.fixture(scope="module")
def few_draws():
    """Both packages' bootstrap at BOOTSTRAP_DRAWS draws (seed 42)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (roc_pr, jroc):
            mp.setattr(mod.bootstrap_ci, "__defaults__",
                       (BOOTSTRAP_DRAWS, 42))
        yield


@pytest.fixture(scope="module")
def payloads(study, few_draws):
    out = {}
    for stage in ("stage1", "stage2"):
        template = str(study / "runs" / stage / "fold{fold}" / "best")
        kw = dict(stage=stage, split="val", folds=list(FOLDS), batch_size=4,
                  decision_thresholds=(0.3, 0.5))
        got = roc_pr.analyze(str(study / f"data_{stage}"), template,
                             dtype=torch.float32, device="cpu", **kw)
        want = jroc.analyze(str(study / f"data_{stage}"), template,
                            dtype=jnp.float32, **kw)
        out[stage] = got, want
    return out


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_analyze_payload_equals_jax(payloads, study, stage):
    got, want = payloads[stage]
    for fold in FOLDS:
        X, _, _ = roc_pr.load_split(str(study / f"data_{stage}"), fold, "val")
        s = roc_pr.positive_scores(
            str(study / "runs" / stage / f"fold{fold}" / "best"), X,
            dtype=torch.float32, device="cpu")
        gaps = np.diff(np.sort(s))
        assert gaps.min() > SCORE_TOL, (
            f"two scores of fold {fold} lie {gaps.min():.2e} apart, under "
            f"the tolerance {SCORE_TOL}: their order may differ between "
            f"the packages")
    _close(got, want)
    for rep_g, rep_w in zip(got["fold_reports"] + [got["aggregate"]],
                            want["fold_reports"] + [want["aggregate"]]):
        assert rep_g["roc_curve"]["fpr"] == rep_w["roc_curve"]["fpr"]
        assert rep_g["roc_curve"]["tpr"] == rep_w["roc_curve"]["tpr"]
        assert rep_g["pr_curve"]["precision"] == rep_w["pr_curve"]["precision"]
        assert rep_g["pr_curve"]["recall"] == rep_w["pr_curve"]["recall"]
        assert rep_g["thr_0.5_confusion"] == rep_w["thr_0.5_confusion"]
    assert [r["split"] for r in got["fold_reports"]] == ["val", "test"]


def test_analyze_cli_and_thresholds_equal_jax(payloads, study, tmp_path,
                                              capsys, few_draws):
    """cli.analyze_roc_pr --device cpu writes the payload that
    cli.extract_thresholds reads; its threshold config equals the one the
    JAX extractor builds from JAX's payload (floats within 1e-5)."""
    paths = {}
    for stage in ("stage1", "stage2"):
        out = tmp_path / f"{stage}.json"
        analyze_roc_pr.main([
            "--stage", stage, "--data-dir", str(study / f"data_{stage}"),
            "--model-root-template",
            str(study / "runs" / stage / "fold{fold}" / "best"),
            "--num-folds", "2", "--batch-size", "4", "--f32",
            "--device", "cpu", "--decision-thresholds", "0.3", "0.5",
            "--output-json", str(out)])
        _close(json.loads(out.read_text()), payloads[stage][0])
        paths[stage] = out
        want = tmp_path / f"jax_{stage}.json"
        want.write_text(json.dumps(payloads[stage][1]))
        paths[f"jax_{stage}"] = want
    extract_thresholds.main([
        "--stage1-metrics", str(paths["stage1"]),
        "--stage2-metrics", str(paths["stage2"]),
        "--output-config", str(tmp_path / "thr.json")])
    jextract.main([
        "--stage1-metrics", str(paths["jax_stage1"]),
        "--stage2-metrics", str(paths["jax_stage2"]),
        "--output-config", str(tmp_path / "jax_thr.json")])
    got = json.loads((tmp_path / "thr.json").read_text())
    assert set(got["folds"]) == {"1", "2"}
    _close(got, json.loads((tmp_path / "jax_thr.json").read_text()))
    assert "Fold 1: stage2" in capsys.readouterr().out


def test_plot_payload(payloads, tmp_path):
    pytest.importorskip("matplotlib")
    got, _ = payloads["stage2"]
    roc_pr.plot_payload(got, str(tmp_path), stage="stage2", combined=True,
                        individual=True, fmt="both")
    for name in ("stage2_roc_combined.png", "stage2_pr_combined.pdf",
                 "stage2_fold1.png", "stage2_fold2.pdf"):
        assert (tmp_path / name).exists(), name


def test_int8_export_scores(study, tmp_path, monkeypatch):
    """An int8 export scores within 1e-3 of JAX's (the packages' int8
    bound: a 1-ulp difference flips a rint of the activation quantization)
    and its kernels reach torch._int_mm column-major, as the engine lays
    them out: on the card a row-major int8 kernel with K <= 64 is refused
    by cuBLASLt."""
    best = str(study / "runs" / "stage1" / "fold1" / "best")
    jparams, jcfg = jconvert.load_hf_model_dir(best)
    d = str(tmp_path / "int8")
    jconvert.save_int8_model_dir(jparams, jcfg, d)
    jtrain_loop.save_feature_extractor_config(d, -1.15, 3.53,
                                              max_length=jcfg.max_length)
    X, _, _ = roc_pr.load_split(str(study / "data_stage1"), 1, "val")
    strides, int_mm = [], torch._int_mm

    def spy(a, b):
        strides.append(b.stride())
        return int_mm(a, b)

    monkeypatch.setattr(torch, "_int_mm", spy)
    got = roc_pr.positive_scores(d, X, batch_size=4, dtype=torch.float32,
                                 device="cpu")
    want = jroc.positive_scores(d, X, batch_size=4, dtype=jnp.float32)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert strides and all(s[0] == 1 for s in strides), strides
