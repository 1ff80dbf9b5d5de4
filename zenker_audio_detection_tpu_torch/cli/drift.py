"""Reproducible quality-drift benchmark (one JSON line); the port of the
JAX package's `cli/drift.py`.

Builds the seed-pinned synthetic corpus, trains both cascade stages with
the frozen recipe, scores them on the calibrated-overlap corpora (the
non-saturating regime of the reference paper, reference
utils/plot_confusion_matrices.py:168-184), and prints ONE JSON line with
every figure plus band verdicts against the frozen pins in
analysis/drift_bench.py:

    python -m zenker_audio_detection_tpu_torch.cli.drift          # the card
    python -m zenker_audio_detection_tpu_torch.cli.drift --cpu    # the CPU
    python -m zenker_audio_detection_tpu_torch.cli.drift --workdir DIR --keep

`--cpu` is `--device cpu`; the default device is CUDA, which raises
without a card. It trains 2x12 epochs of a tiny model.
"""

import argparse
import json
import shutil
import sys
import tempfile
import time


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Quality-drift benchmark: train the frozen synthetic "
                    "recipe and score it on the overlap corpora; one JSON "
                    "line with band verdicts.")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the pin-measurement config); the "
                         "same as --device cpu")
    ap.add_argument("--device", default="cuda",
                    help="device every step runs on (cuda, cuda:N or cpu); "
                         "cuda raises when CUDA is missing")
    ap.add_argument("--workdir", default=None,
                    help="scratch dir (default: fresh temp dir)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the workdir (runs, outputs, corpora)")
    args = ap.parse_args(argv)

    from ..analysis import drift_bench
    from ..infer.cascade import resolve_device

    device = resolve_device("cpu" if args.cpu else args.device)

    workdir = args.workdir or tempfile.mkdtemp(prefix="zenker_drift_")
    made_temp = args.workdir is None
    t0 = time.time()
    try:
        results, checks = drift_bench.run(workdir, str(device))
    finally:
        if made_temp and not args.keep:
            shutil.rmtree(workdir, ignore_errors=True)

    payload = {
        "metric": "quality_drift_patient_accuracy",
        "value": results["patient_acc_f32"],
        "unit": "accuracy",
        "backend": device.type,
        "in_band": all(checks.values()),
        **results,
        "pins": {"s1_auc": drift_bench.PIN_S1_F32,
                 "s2_auc": drift_bench.PIN_S2_F32,
                 "patient_acc": drift_bench.PIN_PATIENT_F32,
                 "band_auc": drift_bench.BAND_AUC,
                 "band_patient": round(drift_bench.BAND_PATIENT, 6)},
        "checks": checks,
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(payload))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        print(f"# FAILED bands: {failed}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
