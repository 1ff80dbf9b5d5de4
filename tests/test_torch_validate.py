"""The port's real-asset validation chain (analysis/validate.py,
cli/validate_real.py), mirroring tests/test_validate_real.py on its
synthetic HF-format fixtures (model directories written by the JAX
package, split data dirs, a long-audio tree and test-id files), with the
port on the CPU (device="cpu", --device cpu) in f32.

`test_converter_gap_accelerator_fallback` has no counterpart here: the
JAX converter check falls back to an accelerator at 1e-2 when its
runtime has no CPU backend, and torch always has the CPU, so the port's
check always runs its f32 forward on the CPU at 1e-3.

Tolerances: the converter gap against transformers <= 1e-3 (the bar of
tests/test_ast_model.py); the report's summed confusion matrices,
verdicts and patient aggregation equal the JAX chain's on the same
fixtures; the ROC/PR payload's floats within 1e-5 of JAX's."""

import json
import os

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.analysis import validate as jvalidate
from zenker_audio_detection_tpu_torch.analysis import validate
from zenker_audio_detection_tpu_torch.cli import validate_real

from test_validate_real import FOLDS, assets  # noqa: F401 (a fixture)

SCORE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (and one for child processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def full_report(assets, tmp_path_factory):  # noqa: F811
    root, runs = assets
    out = str(tmp_path_factory.mktemp("port_report"))
    report = validate.run_validation(
        runs_dir=runs,
        data_stage1=str(root / "data_ast_stage1"),
        data_stage2=str(root / "data_ast_stage2"),
        long_audio_root=str(root / "long_audio"),
        output_dir=out, folds=FOLDS, dtype=torch.float32, device="cpu")
    return report, out


@pytest.fixture(scope="module")
def jax_report(assets, tmp_path_factory):  # noqa: F811
    import jax.numpy as jnp

    root, runs = assets
    out = str(tmp_path_factory.mktemp("jax_report"))
    report = jvalidate.run_validation(
        runs_dir=runs,
        data_stage1=str(root / "data_ast_stage1"),
        data_stage2=str(root / "data_ast_stage2"),
        long_audio_root=str(root / "long_audio"),
        output_dir=out, folds=FOLDS, dtype=jnp.float32)
    return report, out


def test_full_chain_passes_and_reports(full_report):
    report, out = full_report
    assert report["passed"] is True
    assert report["paper_comparable"] is False
    names = {c["name"]: c for c in report["checks"]}

    conv = [c for c in report["checks"] if "converter" in c["name"]]
    assert len(conv) == 2 and all(c["verdict"] == "PASS" for c in conv)
    for c in conv:
        assert "(cpu forward)" in c["ours"]
        assert c["paper"] == "<=1e-03"

    cm_checks = [c for c in report["checks"] if "summed" in c["name"]]
    assert len(cm_checks) == 2
    for c in cm_checks:
        assert c["verdict"] == "INFO"
        assert np.asarray(c["cm"]).sum() == 12

    roc = names["stage1 pooled val ROC-AUC"]
    assert roc["verdict"] == "INFO" and 0.0 <= float(roc["ours"]) <= 1.0
    agg = [c for c in report["checks"] if "aggregation" in c["name"]]
    assert len(agg) == 1 and "4 patients" in agg[0]["ours"]

    with open(os.path.join(out, "validation_report.json")) as f:
        assert json.load(f)["passed"] is True
    assert os.path.exists(os.path.join(out, "roc_pr_stage1.json"))
    assert os.path.exists(os.path.join(out, "patient_aggregate.json"))
    outs = [p for p in os.listdir(os.path.join(out, "outputs"))
            if p.endswith("_2stage.json")]
    assert len(outs) == 4


def test_report_equals_jax(full_report, jax_report):
    """Every check but the converter's (its gap is the forward's own)
    equals the JAX chain's, and so does the patient aggregation."""
    (ours, out), (theirs, jout) = full_report, jax_report
    strip = [{k: v for k, v in c.items() if k != "detail"}
             for c in ours["checks"] if "converter" not in c["name"]]
    jstrip = [{k: v for k, v in c.items() if k != "detail"}
              for c in theirs["checks"] if "converter" not in c["name"]]
    roc = [c for c in strip if "ROC" in c["name"]]
    jroc = [c for c in jstrip if "ROC" in c["name"]]
    assert abs(float(roc[0].pop("ours")) - float(jroc[0].pop("ours"))) \
        <= SCORE_TOL
    assert strip == jstrip
    for name in ("roc_pr_stage1.json", "patient_aggregate.json"):
        # the paths name each run's own output directory
        with open(os.path.join(out, name)) as f1, \
                open(os.path.join(jout, name)) as f2:
            got = json.loads(f1.read().replace(out, "OUT"))
            want = json.loads(f2.read().replace(jout, "OUT"))
        _close(got, want)


def _close(got, want, path="payload"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == want or abs(got - want) <= SCORE_TOL, (path, got, want)
    else:
        assert got == want, (path, got, want)


def test_cm_comparison_discriminates(assets, full_report,  # noqa: F811
                                     tmp_path, monkeypatch):
    root, runs = assets
    report, _ = full_report
    ours = {("stage1" if "stage1" in c["name"] else "stage2"):
            np.asarray(c["cm"])
            for c in report["checks"] if "summed" in c["name"]}

    def rerun(paper, out):
        monkeypatch.setattr(validate, "PAPER_CM", paper)
        return validate.run_validation(
            runs_dir=runs,
            data_stage1=str(root / "data_ast_stage1"),
            data_stage2=str(root / "data_ast_stage2"),
            output_dir=str(tmp_path / out), folds=FOLDS,
            skip_converter=True, dtype=torch.float32, device="cpu")

    good = rerun(ours, "match")
    cm_checks = [c for c in good["checks"] if "summed" in c["name"]]
    assert all(c["verdict"] == "PASS" for c in cm_checks)
    assert good["passed"] is True and good["paper_comparable"] is True

    shifted = {k: v + np.array([[3, -3], [0, 0]]) for k, v in ours.items()}
    bad = rerun(shifted, "shift")
    assert all(c["verdict"] == "FAIL" for c in bad["checks"]
               if "summed" in c["name"])
    assert bad["passed"] is False and bad["paper_comparable"] is True

    half = {"stage1": ours["stage1"],
            "stage2": ours["stage2"] + np.full((2, 2), 1000)}
    part = rerun(half, "half")
    verdicts = {("stage1" if "stage1" in c["name"] else "stage2"):
                c["verdict"]
                for c in part["checks"] if "summed" in c["name"]}
    assert verdicts == {"stage1": "PASS", "stage2": "INFO"}
    assert part["passed"] is True and part["paper_comparable"] is False


def test_cli_exit_codes(assets, tmp_path):  # noqa: F811
    root, runs = assets
    with pytest.raises(SystemExit) as e:
        validate_real.main([
            "--runs-dir", runs,
            "--data-stage1", str(root / "data_ast_stage1"),
            "--data-stage2", str(root / "data_ast_stage2"),
            "--output-dir", str(tmp_path / "cli"),
            "--folds", "1,2", "--skip-converter", "--f32",
            "--device", "cpu"])
    assert e.value.code == 2


def test_cli_without_device_needs_cuda(assets, tmp_path):  # noqa: F811
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    root, runs = assets
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        validate_real.main([
            "--runs-dir", runs,
            "--data-stage1", str(root / "data_ast_stage1"),
            "--data-stage2", str(root / "data_ast_stage2"),
            "--output-dir", str(tmp_path / "cli"), "--skip-converter"])
    assert not (tmp_path / "cli").exists()


def test_manifest_equals_jax():
    """The asset manifest is the JAX package's, word for word."""
    assert validate.asset_manifest() == jvalidate.asset_manifest()
    assert validate.render_manifest_md() == jvalidate.render_manifest_md()
    m = validate.asset_manifest()
    assert m["paper_eval_n"] == {"stage1": 4251, "stage2": 1432}
    for s in ("stage1", "stage2"):
        assert np.array_equal(np.asarray(m["paper_cm"][s]),
                              np.asarray(validate.PAPER_CM[s]))


def test_manifest_doc_and_cli_in_sync(capsys):
    import pathlib

    md = validate.render_manifest_md()
    repo_root = pathlib.Path(__file__).resolve().parents[1]
    assert (repo_root / "VALIDATE_REAL.md").read_text() == md
    validate_real.main(["--print-manifest"])
    assert capsys.readouterr().out.strip() == md.strip()


def test_converter_gap_on_the_cpu(assets):  # noqa: F811
    pytest.importorskip("transformers")
    root, runs = assets
    model_dir = os.path.join(runs, "ast_classifier_stage1", "fold1", "best")
    gap, tol, backend = validate.converter_logit_gap(model_dir)
    assert (tol, backend) == (1e-3, "cpu") and gap <= tol
    jgap, jtol, _ = jvalidate.converter_logit_gap(model_dir)
    assert jtol == tol and abs(gap - jgap) <= 1e-5


def test_single_fold_reads_per_fold_cm(assets, tmp_path_factory):  # noqa: F811
    root, runs = assets
    out = str(tmp_path_factory.mktemp("port_report_single"))
    report = validate.run_validation(
        runs_dir=runs,
        data_stage1=str(root / "data_ast_stage1"),
        data_stage2=str(root / "data_ast_stage2"),
        output_dir=out, folds=[1], skip_converter=True,
        dtype=torch.float32, device="cpu")
    cm_checks = [c for c in report["checks"]
                 if "summed 1-fold CM" in c["name"]]
    assert len(cm_checks) == 2
    assert all(c["verdict"] == "INFO" and "accuracy" in c["detail"]
               for c in cm_checks)
    assert report["paper_comparable"] is False
    for stage in ("stage1", "stage2"):
        p = os.path.join(runs, f"ast_classifier_{stage}", "fold1", "best",
                         "evaluation", "confusion_matrix.npy")
        assert os.path.exists(p), p
