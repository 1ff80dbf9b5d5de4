"""One-command real-asset quality validation (round-3 VERDICT item #3).

The reference's actual deliverable is its published quality numbers — the
summed 5-fold confusion matrices hardcoded at
`utils/plot_confusion_matrices.py:168-184` (Stage 1 92.07 %, Stage 2
73.60 %).  The MIT checkpoint and the study audio are not public; this
module makes proving parity a single command wherever they DO exist:

    python -m zenker_audio_detection_tpu_torch.cli.validate_real \
        --runs-dir <runs> \
        --data-stage1 <data_ast_stage1> --data-stage2 <data_ast_stage2> \
        [--long-audio-root <tree> [--ids-root <dir>]] [--output-dir <dir>]

Chain (each step through this framework's own path, reference cited):

  1. converter fidelity — the port's f32 forward on the CPU vs
     transformers' ASTForAudioClassification on the actual fold
     checkpoints, logits <=1e-3 (same bar as tests/test_ast_model.py)
  2. snippet eval, both stages — summed 5-fold CM via
     analysis/snippet_eval.py (reference src/test_trained_model_stage*_cv.py)
     compared cell-by-cell against the paper CMs with a pass/fail tolerance
  3. ROC/PR — stage-1 validation-split aggregate ROC-AUC via
     analysis/roc_pr.py (reference utils/analyze_ROC_PR_stage1.py)
  4. optional batch 2-stage inference over a long-audio tree
     (cli/run_batch_2stage.py; reference src/run_batch_simple_2stage.py)
  5. optional per-patient aggregation (analysis/aggregate.py; reference
     utils/aggregate_2stage_results.py)

Everything is summarized in a side-by-side table with PASS / FAIL / INFO
verdicts and written to <output-dir>/validation_report.json.  The pipeline
is CI-covered end-to-end on synthetic HF-format fixtures
(tests/test_validate_real.py), so it cannot bit-rot before real assets
appear.

The port of the JAX package's `analysis/validate.py`. Steps 2-5 run on
`device` (CUDA unless the caller names the CPU): the port's snippet
evaluator, ROC/PR analyzer and batch driver. The asset manifest is the
JAX package's, word for word (one VALIDATE_REAL.md describes the assets
of both); the port's command is `python -m
zenker_audio_detection_tpu_torch.cli.validate_real`.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from .cm_plots import PAPER_CM_STAGE1, PAPER_CM_STAGE2

# The paper's summed 5-fold confusion matrices
# (reference utils/plot_confusion_matrices.py:168-184; BASELINE.md) —
# single source of truth in cm_plots so verdicts and plot fallbacks
# cannot disagree about the quality baseline.
PAPER_CM = {
    "stage1": PAPER_CM_STAGE1,
    "stage2": PAPER_CM_STAGE2,
}
STAGE_CLASSES = {"stage1": ("Idle", "Swallow"),
                 "stage2": ("Healthy", "Zenker")}

# The exact checkpoint the reference fine-tunes (its trainers hardcode it:
# src/train_ast_stage1_cross_validation.py:95) — fold dirs exported from it
# are what --runs-dir must contain.
PRETRAINED_CHECKPOINT = "MIT/ast-finetuned-audioset-10-10-0.4593"


def asset_manifest() -> dict[str, Any]:
    """The exact asset tree ``run_validation`` reads — the single source of
    truth for VALIDATE_REAL.md and ``cli.validate_real --print-manifest``
    (VERDICT r4 item #7: an external runner must be able to check their
    mounts BEFORE running, and must not misread exit 2). The JAX
    package's manifest, word for word (tests/test_torch_validate.py)."""
    return {
        "pretrained_checkpoint": PRETRAINED_CHECKPOINT,
        "folds": list(range(1, 6)),
        # Eval-set sizes implied by the paper CMs: the stage CM comparison
        # only gets a PASS/FAIL verdict (and exit code 0/1) when the summed
        # fold CM over --folds counts EXACTLY this many windows; any other
        # N -> INFO verdict -> exit 2 (INCONCLUSIVE)
        "paper_eval_n": {s: int(PAPER_CM[s].sum()) for s in PAPER_CM},
        "paper_cm": {s: np.asarray(PAPER_CM[s], dtype=int).tolist()
                     for s in PAPER_CM},
        "paper_accuracy": {s: round(_cm_accuracy(PAPER_CM[s]), 4)
                           for s in PAPER_CM},
        # file patterns actually opened, per fold K in --folds
        "runs_tree": [
            "<runs-dir>/ast_classifier_stage{1,2}/fold{K}/best/"
            "model.safetensors",
            "<runs-dir>/ast_classifier_stage{1,2}/fold{K}/best/config.json",
            "<runs-dir>/ast_classifier_stage{1,2}/fold{K}/best/"
            "preprocessor_config.json",
        ],
        "data_tree": {
            "data_stage1": ["test_x_fold{K}.npy", "test_y_fold{K}.npy",
                            "val_x_fold{K}.npy (ROC step; falls back to "
                            "test)", "val_y_fold{K}.npy (same)"],
            "data_stage2": ["test_x_fold{K}.npy", "test_y_fold{K}.npy"],
            "note": "the *_x_* arrays hold WAV paths that must resolve on "
                    "THIS machine (re-run the split prep against the local "
                    "audio root if they were created elsewhere)",
        },
        "optional": {
            "long_audio_root": "<root>/<Class>/<patient-id>/*.wav "
                               "(Class in {Healthy, Zenker})",
            "ids_root": "test_ids_fold{K}.txt (defaults to --data-stage2)",
        },
        "exit_codes": {
            "0": "all checks passed AND both stages' summed CMs were "
                 "compared against the paper's (eval Ns matched)",
            "1": "a check FAILED (converter parity or a CM cell gap "
                 "beyond --cm-tolerance)",
            "2": "INCONCLUSIVE: every check clean but the eval-set N "
                 "never matched the paper's for both stages — wrong "
                 "splits, partial or synthetic data; quality parity is "
                 "NOT established and CI must not treat this as a pass",
        },
    }


def render_manifest_md() -> str:
    """VALIDATE_REAL.md body rendered from `asset_manifest()` (kept
    byte-identical by the selftest so the doc can't drift)."""
    m = asset_manifest()
    lines = [
        "# VALIDATE_REAL — asset manifest for `zenker-validate-real`",
        "",
        "Generated from `analysis/validate.py:asset_manifest()` "
        "(`zenker-validate-real --print-manifest` prints the same text; "
        "the selftest keeps this file in sync). Mount exactly this tree "
        "before running; anything else yields exit 2, not parity.",
        "",
        "## Checkpoints (`--runs-dir`)",
        "",
        f"Fold checkpoints fine-tuned from `{m['pretrained_checkpoint']}` "
        f"(the reference trainers hardcode it), folds "
        f"{m['folds'][0]}-{m['folds'][-1]}:",
        "",
    ]
    lines += [f"- `{p}`" for p in m["runs_tree"]]
    lines += [
        "",
        "## Split data (`--data-stage1`, `--data-stage2`)",
        "",
        f"- data_stage1: " + ", ".join(
            f"`{f}`" for f in m["data_tree"]["data_stage1"]),
        f"- data_stage2: " + ", ".join(
            f"`{f}`" for f in m["data_tree"]["data_stage2"]),
        "",
        f"Note: {m['data_tree']['note']}.",
        "",
        "## Optional long-audio cascade",
        "",
        f"- `--long-audio-root`: {m['optional']['long_audio_root']}",
        f"- `--ids-root`: {m['optional']['ids_root']}",
        "",
        "## Paper eval-set sizes (the exit-0 gate)",
        "",
        "The paper-CM comparison only carries a PASS/FAIL verdict when the "
        "summed fold CM counts exactly the published window totals "
        "(reference `utils/plot_confusion_matrices.py:168-184`):",
        "",
    ]
    for s in ("stage1", "stage2"):
        lines.append(
            f"- {s} ({' vs '.join(STAGE_CLASSES[s])}): N = "
            f"{m['paper_eval_n'][s]}, paper CM {m['paper_cm'][s]}, "
            f"accuracy {100 * m['paper_accuracy'][s]:.2f} %")
    lines += ["", "## Exit codes", ""]
    for code in ("0", "1", "2"):
        lines.append(f"- `{code}` — {m['exit_codes'][code]}")
    lines.append("")
    return "\n".join(lines)


def converter_logit_gap(model_dir: str) -> tuple[float, float, str]:
    """(max |logit| gap, tolerance, backend) between the port's forward and
    transformers' `ASTForAudioClassification` on the SAME checkpoint dir
    (converter + model fidelity on the deployed weights).

    Converter fidelity is a property of the weights, not of the serving
    device, so the port's forward runs in f32 on the CPU, where it matches
    transformers at <=1e-3 (tests/test_ast_model.py's bar). The JAX
    function falls back to an accelerator at 1e-2 when its runtime has no
    CPU backend; torch always has the CPU, so that fallback has no
    counterpart here."""
    import transformers

    from ..models import ast as ast_mod, convert

    params, config = convert.load_hf_model_dir(model_dir)
    ref = transformers.ASTForAudioClassification.from_pretrained(
        model_dir).eval()
    rng = np.random.default_rng(0)
    feats = rng.standard_normal(
        (2, config.max_length, config.num_mel_bins)).astype(np.float32)
    with torch.inference_mode():
        ours = ast_mod.forward(params, torch.from_numpy(feats), config,
                               dtype=torch.float32).numpy()
        want = ref(torch.from_numpy(feats)).logits.numpy()
    return float(np.abs(ours - want).max()), 1e-3, "cpu"


def _cm_accuracy(cm: np.ndarray) -> float:
    cm = np.asarray(cm, dtype=np.float64)
    return float(np.trace(cm) / max(1.0, cm.sum()))


def _fmt_cm(cm) -> str:
    cm = np.asarray(cm, dtype=int)
    return "[[%d, %d], [%d, %d]]" % tuple(cm.ravel())


def _compare_cm(cm: np.ndarray, paper: np.ndarray,
                cm_tolerance: float) -> tuple[str, str]:
    """(verdict, detail) for an evaluated CM vs the paper's.  Comparable
    only when the evaluation-set size matches the paper's; otherwise the
    result is informational (different data => different counts, by
    construction, reference README 'dataset not public')."""
    cm, paper = np.asarray(cm), np.asarray(paper)
    if cm.sum() != paper.sum():
        return "INFO", (f"eval set N={int(cm.sum())} != paper "
                        f"N={int(paper.sum())}; counts not comparable — "
                        f"accuracy {100 * _cm_accuracy(cm):.2f}% vs paper "
                        f"{100 * _cm_accuracy(paper):.2f}%")
    tol = max(1, int(round(cm_tolerance * paper.sum())))
    gap = int(np.abs(cm - paper).max())
    verdict = "PASS" if gap <= tol else "FAIL"
    return verdict, f"max cell gap {gap} (tolerance {tol} windows)"


def run_validation(*, runs_dir: str, data_stage1: str, data_stage2: str,
                   long_audio_root: str | None = None,
                   ids_root: str | None = None,
                   output_dir: str = "validation",
                   folds=None, batch_size: int = 8,
                   cm_tolerance: float = 0.005,
                   aggregate_threshold: float = 0.5,
                   skip_converter: bool = False,
                   dtype=None, device=None) -> dict[str, Any]:
    """Run the full validation chain; returns the report dict (also written
    to <output_dir>/validation_report.json).  `dtype=None` uses each tool's
    default (bf16); pass torch.float32 to remove the bf16 boundary from
    the comparison. `device` None is CUDA, which raises without a card."""
    from ..infer.cascade import resolve_device
    from . import aggregate as agg_mod, roc_pr, snippet_eval

    device = resolve_device(device)
    folds = list(folds) if folds else list(range(1, 6))
    os.makedirs(output_dir, exist_ok=True)
    checks: list[dict[str, Any]] = []
    data_dirs = {"stage1": data_stage1, "stage2": data_stage2}

    # 1. converter fidelity on the deployed weights
    for stage in ("stage1", "stage2"):
        name = f"converter logit parity ({stage} fold{folds[0]})"
        if skip_converter:
            checks.append({"name": name, "verdict": "SKIP",
                           "detail": "--skip-converter"})
            continue
        model_dir = os.path.join(runs_dir, f"ast_classifier_{stage}",
                                 f"fold{folds[0]}", "best")
        try:
            gap, tol, backend = converter_logit_gap(model_dir)
            checks.append({
                "name": name,
                "verdict": "PASS" if gap <= tol else "FAIL",
                "ours": f"max|dlogit| {gap:.2e} ({backend} forward)",
                "paper": f"<={tol:.0e}",
                "detail": model_dir})
        except ImportError as e:
            checks.append({"name": name, "verdict": "SKIP",
                           "detail": f"torch/transformers unavailable: {e}"})

    # 2. snippet eval: summed fold CM per stage vs the paper's
    cms = {}
    for stage in ("stage1", "stage2"):
        out = snippet_eval.evaluate_all_folds(
            stage=stage, data_dir=data_dirs[stage],
            model_root=os.path.join(runs_dir, f"ast_classifier_{stage}"),
            central_results_dir=os.path.join(output_dir, "central_results"),
            folds=folds, batch_size=batch_size, dtype=dtype, device=device)
        if "aggregate_confusion_matrix" in out:
            cm = np.asarray(out["aggregate_confusion_matrix"])
        else:  # single fold: evaluate_fold wrote the per-fold CM to disk
            cm = _single_fold_cm(runs_dir, stage, folds[0])
        cms[stage] = cm
        verdict, detail = _compare_cm(cm, PAPER_CM[stage], cm_tolerance)
        checks.append({
            "name": f"{stage} summed {len(folds)}-fold CM "
                    f"({' vs '.join(STAGE_CLASSES[stage])})",
            "verdict": verdict, "ours": _fmt_cm(cm),
            "paper": _fmt_cm(PAPER_CM[stage]), "detail": detail,
            "cm": np.asarray(cm, dtype=int).tolist(),
            "accuracy": _cm_accuracy(cm)})

    # 3. ROC/PR on the stage-1 validation split
    roc_payload = roc_pr.analyze(
        data_stage1,
        os.path.join(runs_dir, "ast_classifier_stage1", "fold{fold}", "best"),
        stage="stage1", split="val", folds=folds, batch_size=batch_size,
        output_json=os.path.join(output_dir, "roc_pr_stage1.json"),
        dtype=dtype, device=device)
    auc = roc_payload["aggregate"]["roc_auc"]
    checks.append({
        "name": "stage1 pooled val ROC-AUC", "verdict": "INFO",
        "ours": f"{auc:.4f}",
        "paper": "n/a (not published; sanity floor ~0.9)",
        "detail": "analysis/roc_pr.py aggregate over "
                  f"folds {folds}"})

    # 4+5. optional cascade + patient aggregation over real long audio
    if long_audio_root:
        from ..cli import run_batch_2stage

        outputs_dir = os.path.join(output_dir, "outputs")
        for fold in folds:
            # --force: a validation must recompute, never reuse per-patient
            # JSONs from a previous run against older checkpoints
            argv = ["--fold", str(fold),
                    "--long-audio-root", long_audio_root,
                    "--ids-root", ids_root or data_stage2,
                    "--output-dir", outputs_dir,
                    "--model-root", runs_dir, "--force",
                    "--batch-size", str(max(batch_size, 8)),
                    "--device", str(device)]
            if dtype == torch.float32:  # bf16/None = the tool's default
                argv.append("--f32")
            run_batch_2stage.main(argv)
        agg = agg_mod.aggregate_outputs(
            outputs_dir, threshold=aggregate_threshold,
            json_path=os.path.join(output_dir, "patient_aggregate.json"))
        checks.append({
            "name": "patient-level aggregation (ZSR >= "
                    f"{aggregate_threshold})",
            "verdict": "INFO",
            "ours": f"accuracy {agg['summary']['metrics']['accuracy']:.3f} "
                    f"over {agg['summary']['num_patient_results']} patients",
            "paper": "n/a (per-patient table not published)",
            "detail": outputs_dir})
    else:
        checks.append({"name": "cascade + patient aggregation",
                       "verdict": "SKIP",
                       "detail": "no --long-audio-root given"})

    summed = [c for c in checks if "summed" in c["name"]]
    report = {
        "runs_dir": runs_dir, "folds": folds,
        "checks": checks,
        "passed": all(c["verdict"] != "FAIL" for c in checks),
        # the runbook's PURPOSE is the paper-CM comparison; when the
        # evaluated N never matches the paper's, the CM check is INFO and
        # "nothing failed" must not read as "quality parity proven".
        # BOTH stages must have received a real verdict: with any(), a
        # correct --data-stage1 paired with a wrong --data-stage2 tree
        # would certify parity while stage 2's published CM was never
        # compared
        "paper_comparable": len(summed) == 2 and all(
            c["verdict"] in ("PASS", "FAIL") for c in summed),
    }
    with open(os.path.join(output_dir, "validation_report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print_report(report)
    return report


def _single_fold_cm(runs_dir: str, stage: str, fold: int) -> np.ndarray:
    from ..utils.fsio import load_npy
    return load_npy(os.path.join(runs_dir, f"ast_classifier_{stage}",
                                 f"fold{fold}", "best", "evaluation",
                                 "confusion_matrix.npy"),
                    "confusion-matrix file")


def print_report(report: dict) -> None:
    print("\n" + "=" * 78)
    print("REAL-ASSET VALIDATION — side-by-side vs the paper "
          "(utils/plot_confusion_matrices.py:168-184)")
    print("=" * 78)
    for c in report["checks"]:
        print(f"[{c['verdict']:>4}] {c['name']}")
        if "ours" in c:
            print(f"       ours : {c['ours']}")
            print(f"       paper: {c['paper']}")
        if c.get("detail"):
            print(f"       note : {c['detail']}")
    print("-" * 78)
    if not report["passed"]:
        print("OVERALL: FAIL")
    elif report.get("paper_comparable", True):
        print("OVERALL: PASS")
    else:
        print("OVERALL: INCONCLUSIVE — every check ran clean, but the "
              "evaluation-set sizes never matched the paper's, so the "
              "published confusion matrices were not actually compared "
              "(wrong --data-stage* splits, or a partial/synthetic "
              "dataset)")
    print("=" * 78)
