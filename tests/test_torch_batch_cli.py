"""The port's batch drivers (cli/run_batch_2stage.py, cli/run_all_folds.py)
and the pure-Python modules they import (analysis/thresholds.py,
analysis/aggregate.py, data/config.py, cli/aggregate_results.py,
infer/plotting.py) against the JAX package's, on one study tree: two folds
of tiny random-init stage directories exported by the JAX package, and
three patients of two 3 s recordings each. Per-patient JSONs must equal
the JAX drivers' (structure, strings and counts exact, floats to 1e-5);
the port runs with --device cpu."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.analysis import thresholds as jthresholds
from zenker_audio_detection_tpu.audio import io as jaio
from zenker_audio_detection_tpu.cli import aggregate_results as jagg_cli
from zenker_audio_detection_tpu.cli import run_all_folds as jall
from zenker_audio_detection_tpu.cli import run_batch_2stage as jbatch
from zenker_audio_detection_tpu.data import config as jenv
from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu.models import convert as jconvert
from zenker_audio_detection_tpu.train import loop as jtrain_loop
from zenker_audio_detection_tpu_torch.analysis import thresholds
from zenker_audio_detection_tpu_torch.cli import aggregate_results as agg_cli
from zenker_audio_detection_tpu_torch.cli import infer_long_audio
from zenker_audio_detection_tpu_torch.cli import run_all_folds
from zenker_audio_detection_tpu_torch.cli import run_batch_2stage
from zenker_audio_detection_tpu_torch.data import config as env
from zenker_audio_detection_tpu_torch.infer import plotting

PATIENTS = {1: ("Zenker/Z01", "Healthy/H01"), 2: ("Zenker/Z02",)}


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
def study(tmp_path_factory):
    """runs/ast_classifier_stage{1,2}/fold{1,2}/best, the test-id lists,
    the recordings and a per-fold threshold config."""
    root = tmp_path_factory.mktemp("port_batch_study")
    cfg = jast.ASTConfig(hidden_size=32, num_hidden_layers=1,
                         num_attention_heads=2, intermediate_size=64,
                         max_length=128, num_labels=2)
    for fold in (1, 2):
        for stage, seed, labels in [
                ("stage1", fold, {0: "Idle", 1: "Swallow"}),
                ("stage2", 10 + fold, {0: "Healthy", 1: "Zenker"})]:
            d = root / "runs" / f"ast_classifier_{stage}" / f"fold{fold}" \
                / "best"
            params = jax.tree.map(np.asarray, jast.init_params(
                jax.random.PRNGKey(seed), cfg))
            # a random head, so that the gate splits the windows
            head = params["head"]["dense"]
            head["kernel"] = np.random.default_rng(seed).standard_normal(
                head["kernel"].shape).astype(np.float32)
            head["bias"] = np.array([0.0, 0.2], np.float32)
            jconvert.save_hf_model_dir(params, cfg, str(d), labels)
            jtrain_loop.save_feature_extractor_config(
                str(d), -1.15, 3.53, max_length=cfg.max_length)
    ids = root / "data_ast_stage2"
    ids.mkdir()
    rng = np.random.default_rng(9)
    for fold, pids in PATIENTS.items():
        (ids / f"test_ids_fold{fold}.txt").write_text(
            "".join(f"{p}\n" for p in pids))
        for pid in pids:
            pdir = root / "Long" / pid
            pdir.mkdir(parents=True)
            for fn in ("recA.wav", "recB.wav"):
                jaio.write_wav(str(pdir / fn), (rng.standard_normal(
                    16000 * 3) * 0.3).astype(np.float32), 16000)
    (root / "thr.json").write_text(json.dumps({"folds": {
        "1": {"stage1": {"threshold": 0.45}, "stage2": {"threshold": 0.55}}
    }}))
    return root


def json_close(got, want, path="$"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            json_close(a, b, f"{path}[{i}]")
    elif isinstance(want, float) or isinstance(got, float):
        assert abs(float(got) - float(want)) < 1e-5, (path, got, want)
    else:
        assert got == want, (path, got, want)


def batch_args(study, fold, out, *extra):
    return ["--fold", str(fold), "--ids-root", str(study / "data_ast_stage2"),
            "--long-audio-root", str(study / "Long"), "--model-root",
            str(study / "runs"), "--output-dir", str(out), "--f32",
            "--disable-cache", *extra]


def load_outputs(out):
    return {f: json.loads((out / f).read_text())
            for f in sorted(os.listdir(out)) if f.endswith("_2stage.json")}


def test_run_batch_matches_jax(study, tmp_path, capsys):
    """One fold through both batch drivers, with the per-fold threshold
    config: the same per-patient JSONs; the port's --plot writes the cache
    variant's artifact names."""
    thr = ["--threshold-config", str(study / "thr.json")]
    port = run_batch_2stage.main(batch_args(study, 1, tmp_path / "port",
                                            *thr, "--device", "cpu",
                                            "--plot"))
    out = capsys.readouterr().out
    assert "[Thresholds] stage1 <- 0.45" in out
    assert "[Thresholds] stage2 <- 0.55" in out
    want = jbatch.main(batch_args(study, 1, tmp_path / "jax", *thr))
    assert port == want == {"done": 2, "failed": 0, "skipped": 0}
    got, ref = load_outputs(tmp_path / "port"), load_outputs(tmp_path / "jax")
    assert sorted(got) == ["H01_2stage.json", "Z01_2stage.json"] == sorted(
        ref)
    json_close(got, ref)
    assert got["Z01_2stage.json"]["config"]["stage1_threshold"] == 0.45
    for pid in ("Z01", "H01"):
        for ext in ("png", "pdf"):
            assert (tmp_path / "port" / f"{pid}_2stage_plot_cached.{ext}"
                    ).stat().st_size > 0


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_run_batch_attention_impl(study, tmp_path, monkeypatch, impl):
    """--attention-impl reaches the fold's engine (default kernel; torch is
    the counterpart of the JAX driver's XLA attention and serves head
    widths the kernels do not take); the JSONs equal the JAX driver's."""
    from zenker_audio_detection_tpu_torch.infer import cascade

    seen, engine = [], cascade.TwoStageEngine

    def spy(s1, s2, config, **kw):
        seen.append(config.attention_impl)
        return engine(s1, s2, config, **kw)

    monkeypatch.setattr(cascade, "TwoStageEngine", spy)
    extra = [] if impl == "kernel" else ["--attention-impl", impl]
    run_batch_2stage.main(batch_args(study, 1, tmp_path / "port",
                                     "--device", "cpu", *extra))
    assert seen == [impl]
    jbatch.main(batch_args(study, 1, tmp_path / "jax"))
    json_close(load_outputs(tmp_path / "port"), load_outputs(tmp_path / "jax"))


def test_run_batch_skips_existing_and_reruns_corrupt(study, tmp_path,
                                                     capsys):
    args = batch_args(study, 1, tmp_path, "--device", "cpu")
    run_batch_2stage.main(args)
    victim = tmp_path / "H01_2stage.json"
    good = victim.read_text()
    victim.write_text(good[: len(good) // 2])  # truncated mid-write
    capsys.readouterr()
    counts = run_batch_2stage.main(args)
    out = capsys.readouterr().out
    assert "[STALE]" in out and "[RUN] H01" in out
    assert "[SKIP] Z01" in out
    assert counts == {"done": 1, "failed": 0, "skipped": 1}
    assert json.loads(victim.read_text()) == json.loads(good)
    # --force re-runs both; --extra tokens parse as flags of this command
    assert run_batch_2stage.main(args + ["--force"])["done"] == 2
    capsys.readouterr()
    run_batch_2stage.main(args + ["--extra", "--dry-run --force"])
    assert capsys.readouterr().out.count("[DRY-RUN]") == 2


def test_run_all_folds_matches_jax_and_aggregates(study, tmp_path,
                                                  monkeypatch):
    """Sequential folds with --aggregate in both packages: the same
    per-patient JSONs and the same patient-level aggregate; the port's
    --parallel-folds (one thread per fold) writes the same JSONs bit for
    bit."""
    common = [str(study / "runs"), "--long-audio-root", str(study / "Long"),
              "--ids-root", str(study / "data_ast_stage2"), "--num-folds",
              "2", "--f32", "--no-threshold-config"]
    # each package in a directory of its own: the frame caches stay apart
    for side, main, extra in (("port", run_all_folds.main,
                               ["--device", "cpu"]), ("jax", jall.main, [])):
        (tmp_path / side).mkdir()
        monkeypatch.chdir(tmp_path / side)
        main(common + ["--output-dir", str(tmp_path / side / "out"),
                       "--aggregate"] + extra)
    got = load_outputs(tmp_path / "port" / "out")
    ref = load_outputs(tmp_path / "jax" / "out")
    assert len(got) == 3
    json_close(got, ref)
    assert sum(j["aggregate"]["total_swallow_windows"]
               for j in got.values()) > 0
    summaries = [json.loads((tmp_path / side / "out" /
                             "aggregate_summary.json").read_text())
                 for side in ("port", "jax")]
    assert summaries[0]["summary"]["num_patient_results"] == 3
    for s in summaries:
        del s["summary"]["outputs_dir"]
    json_close(summaries[0]["summary"], summaries[1]["summary"])
    assert (tmp_path / "port" / "out" / "per_patient_results.csv").exists()

    (tmp_path / "par").mkdir()
    monkeypatch.chdir(tmp_path / "par")
    run_all_folds.main(common + ["--output-dir", str(tmp_path / "par" / "out"),
                                 "--parallel-folds", "--device", "cpu"])
    assert load_outputs(tmp_path / "par" / "out") == got


def test_run_all_folds_dry_run_and_forwarding(study, tmp_path, monkeypatch,
                                              capsys):
    monkeypatch.chdir(tmp_path)
    run_all_folds.main(["runs", "--long-audio-root", str(study / "Long"),
                        "--ids-root", str(study / "data_ast_stage2"),
                        "--num-folds", "2", "--dry-run",
                        "--no-threshold-config"])
    out = capsys.readouterr().out
    assert out.count("[DRY-RUN]") == 3
    assert "Fold 1" in out and "Fold 2" in out

    seen = []
    monkeypatch.setattr(run_batch_2stage, "main",
                        lambda argv, **kw: seen.append(list(argv)) or
                        {"done": 0, "failed": 0, "skipped": 0})
    run_all_folds.main(["runs", "--long-audio-root", "Long",
                        "--num-folds", "1", "--no-threshold-config",
                        "--pattern", "rec_*.wav", "--plot", "--int8",
                        "--device", "cuda:1"])
    (argv,) = seen
    assert argv[argv.index("--pattern") + 1] == "rec_*.wav"
    assert argv[argv.index("--device") + 1] == "cuda:1"
    assert "--plot" in argv and "--int8" in argv


@pytest.mark.parametrize("argv,exc,match", [
    (["--num-devices", "2"], RuntimeError,
     "No such file or directory: 'data_ast_stage2/test_ids_fold1.txt'"),
    (["--num-slices", "2"], FileNotFoundError,
     "data_ast_stage2/test_ids_fold1.txt"),
    (["--data-per-fold", "2"], SystemExit,
     "--data-per-fold requires --parallel-folds")])
def test_run_all_folds_sharding_flags_name_a10(argv, exc, match, tmp_path,
                                               monkeypatch):
    """The sharding flags do what the JAX driver's do: --data-per-fold
    without --parallel-folds is its SystemExit; --num-devices 2 runs the
    folds on two ranks and --num-slices 2 in this process, and both fail on
    the missing default id list, as JAX's driver fails (in each rank, as
    the launcher reports it)."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(exc, match=match):
        run_all_folds.main(["runs", "--long-audio-root", str(tmp_path),
                            "--device", "cpu"] + argv)
    with pytest.raises(SystemExit if exc is SystemExit
                       else FileNotFoundError, match=match):
        jall.main(["runs", "--long-audio-root", str(tmp_path)] + argv)


@pytest.mark.parametrize("argv", [["--num-devices", "2"],
                                  ["--num-slices", "2"]])
def test_batch_and_infer_sharding_flags_name_a10(study, tmp_path, argv):
    """The sharding flags of the batch driver and of infer_long_audio do
    what JAX's do. --num-devices 2: the fold's windows over two ranks give
    the JAX driver's JSONs (also through --extra); infer_long_audio fails
    on a missing model dir in each rank. --num-slices 2 alone: JAX's
    ValueError from make_mesh, and infer_long_audio's missing model dir
    before it. A mesh that is no DeviceMesh fails as JAX's fails on one
    that is no Mesh."""
    dev = ["--device", "cpu", "--attention-impl", "torch"]
    flags = " ".join(argv)
    if argv[0] == "--num-devices":
        want = jbatch.main(batch_args(study, 1, tmp_path / "jax"))
        ref = load_outputs(tmp_path / "jax")
        for tag, extra in (("flags", argv), ("extra", ["--extra", flags])):
            got = run_batch_2stage.main(batch_args(
                study, 1, tmp_path / tag, *dev, *extra))
            assert got == want == {"done": 2, "failed": 0, "skipped": 0}
            json_close(load_outputs(tmp_path / tag), ref)
        infer_exc, infer_match = RuntimeError, "FileNotFoundError"
    else:
        for extra in (argv, ["--extra", flags]):
            with pytest.raises(ValueError, match="requires num_devices > 1"):
                run_batch_2stage.main(batch_args(study, 1, tmp_path,
                                                 *dev, *extra))
            with pytest.raises(ValueError, match="requires num_devices > 1"):
                jbatch.main(batch_args(study, 1, tmp_path / "j", *extra))
        infer_exc, infer_match = FileNotFoundError, "fold1/best"
    with pytest.raises(infer_exc, match=infer_match):
        infer_long_audio.main(["--file-a", "a.wav", "--file-b", "b.wav",
                               "--fold", "1", "--model-root",
                               str(tmp_path / "none"), *dev, *argv])
    with pytest.raises(AttributeError):
        run_batch_2stage.main(batch_args(study, 1, tmp_path / "m", *dev),
                              mesh=object())
    with pytest.raises(AttributeError):
        jbatch.main(batch_args(study, 1, tmp_path / "jm"), mesh=object())


def test_threshold_config_matches_jax(tmp_path):
    metrics = tmp_path / "metrics.json"
    metrics.write_text(json.dumps({
        "fold_reports": [
            {"fold": 1, "best_f1_threshold": 0.4, "best_f1": 0.8,
             "best_f1_precision": 0.7, "best_f1_recall": 0.9},
            {"fold": 2, "best_f1_threshold": 0.6},
            {"fold": 3}],
        "aggregate": {"best_f1_threshold": 0.5, "best_f1": 0.75}}))
    got = thresholds.build_threshold_config(str(metrics), str(metrics),
                                            str(tmp_path / "port.json"))
    want = jthresholds.build_threshold_config(str(metrics), str(metrics),
                                              str(tmp_path / "jax.json"))
    assert got == want and sorted(got["folds"]) == ["1", "2"]
    assert ((tmp_path / "port.json").read_text()
            == (tmp_path / "jax.json").read_text())
    for fold in (1, 2, 3):
        assert (thresholds.load_fold_thresholds(str(tmp_path / "port.json"),
                                                fold)
                == jthresholds.load_fold_thresholds(
                    str(tmp_path / "jax.json"), fold))
    legacy = tmp_path / "legacy.json"
    legacy.write_text(json.dumps({"thresholds": {"stage2": {
        "threshold": 0.3}}}))
    assert thresholds.load_fold_thresholds(str(legacy), 4) == {
        "stage1": None, "stage2": 0.3}
    legacy.write_text("{not json")
    with pytest.raises(ValueError, match="legacy.json"):
        thresholds.load_fold_thresholds(str(legacy), 1)


def test_dataset_config_matches_jax(tmp_path, monkeypatch):
    (tmp_path / ".env").write_text(
        "DATASET_ROOT=/data/set\nLONG_AUDIO_DIR=${DATASET_ROOT}/Long\n"
        "# comment\nRAW_DATA_DIR='${EXPORTED}/raw'\n")
    monkeypatch.setenv("EXPORTED", "/exp")
    monkeypatch.delenv("LONG_AUDIO_ROOT", raising=False)
    monkeypatch.delenv("DATASET_ROOT", raising=False)
    got = env.load_dataset_config(tmp_path)
    assert got == jenv.load_dataset_config(tmp_path)
    assert got["long_audio_root"] == "/data/set/Long"
    assert got["raw_data_dir"] == "/exp/raw"


def test_aggregate_cli_matches_jax(tmp_path):
    for pid, cls, ratio in (("Z1", "Zenker", 0.8), ("H1", "Healthy", 0.1),
                            ("H2", "Healthy", 0.7)):
        (tmp_path / f"{pid}_2stage.json").write_text(json.dumps({
            "aggregate": {
                "files_used": [f"/d/{cls}/{pid}/a.wav"],
                "overall_zenker_ratio_over_swallow": ratio,
                "total_swallow_windows": 10, "total_zenker_windows":
                    int(10 * ratio), "total_healthy_windows":
                    10 - int(10 * ratio), "total_windows": 20}}))
    args = ["--outputs-dir", str(tmp_path), "--threshold", "0.5"]
    agg_cli.main(args + ["--json", str(tmp_path / "port.json")])
    jagg_cli.main(args + ["--json", str(tmp_path / "jax.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    assert got == json.loads((tmp_path / "jax.json").read_text())
    assert got["summary"]["num_patient_results"] == 3


def test_plotting_artifact_names(tmp_path):
    rng = np.random.default_rng(3)
    assets = [((rng.standard_normal(16000 * 3) * 0.1).astype(np.float32),
               [0, 1, 1, 0, 1], [-1, 0, 1, -1, -1], f"File {i}",
               f"/data/Zenker/p7/f{i}.wav") for i in range(2)]
    assert plotting.plot_two_stage(assets, 1.0, 0.5, str(tmp_path),
                                   patient_id="p7") == str(
        tmp_path / "p7_2stage_plot.png")
    cached = plotting.plot_two_stage(assets, 1.0, 0.5, str(tmp_path),
                                     patient_id="p7", cached_name=True)
    assert cached == str(tmp_path / "p7_2stage_plot_cached.png")
    assert os.path.getsize(cached.replace(".png", ".pdf")) > 0
    assert plotting.ground_truth_from_path("/x/healthy/p2/a.wav") == "Healthy"


def test_infer_cli_int8_plot_and_trace(study, tmp_path):
    """infer_long_audio --int8 --plot --plot-dir --trace-dir: the JAX CLI's
    int8 JSON (at the int8 tolerance of tests/test_torch_serve.py), the
    base script's plot names, and a torch.profiler Chrome trace."""
    common = ["--patient-id", "Z01", "--long-audio-root", str(study / "Long"),
              "--fold", "1", "--model-root", str(study / "runs"), "--f32",
              "--disable-cache", "--int8", "--show-first-n", "0"]
    from zenker_audio_detection_tpu.cli import infer_long_audio as jinfer

    infer_long_audio.main(common + [
        "--device", "cpu", "--output-json", str(tmp_path / "port.json"),
        "--plot", "--plot-dir", str(tmp_path / "plots"), "--trace-dir",
        str(tmp_path / "trace")])
    jinfer.main(common + ["--output-json", str(tmp_path / "jax.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got["aggregate"]["total_windows"] == 10
    assert got["aggregate"] == pytest.approx(want["aggregate"], abs=1e-3)
    for ext in ("png", "pdf"):
        assert (tmp_path / "plots" / f"Z01_2stage_plot.{ext}").stat(
            ).st_size > 0
    (trace,) = os.listdir(tmp_path / "trace")
    events = json.loads((tmp_path / "trace" / trace).read_text())
    assert trace.endswith(".json") and events["traceEvents"]
