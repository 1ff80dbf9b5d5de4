"""The port's fine-tuning loop (`train/loop.py`) and its CLIs against the
JAX package's, on tests/test_train_loop.py's tiny task.

`run_cross_validation([1], cfg)` runs in both packages from ONE parameter
tree: each `init_model` is replaced by one that returns the JAX package's
`init_params` tree (the port's through `params_from_jax`), since the JAX
PRNGKey stream cannot be reproduced. Hidden 32, 2 layers, 4 heads, f32,
batch 4, no augmentation, 3 epochs, on the CPU (`device="cpu"`). The
per-epoch train losses and eval metrics agree at 1e-4, the fold metrics
too, and the best directory's parameters at 1e-4 except the key bias:
its gradient is zero in exact arithmetic (softmax is invariant to a
per-row shift of the scores), both sides hold rounding noise there, and
Adam turns that into steps of up to the learning rate, so that leaf is
held to the learning rate (ROADMAP C, "Traps").

Also, within the port: the artifact contract and the HF reload
(tests/test_train_loop.py:94-133), the dry run, the run-dir backup,
streaming equal to eager bit for bit, the tracking channels, featurization
against the JAX package (1e-5; 1e-3 in bins near the log floor, as
tests/test_golden.py), the fields and flags of several devices as the JAX
trainer takes them, the refusal of a missing CUDA, and the CLIs."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.audio import native as jax_native
from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu.models import convert as jconvert
from zenker_audio_detection_tpu.train import loop as JL
from zenker_audio_detection_tpu_torch.audio import native as port_native
from zenker_audio_detection_tpu_torch.cli import compute_stats as cli_stats
from zenker_audio_detection_tpu_torch.cli import train_stage1 as cli_s1
from zenker_audio_detection_tpu_torch.cli import train_stage2 as cli_s2
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.models import convert
from zenker_audio_detection_tpu_torch.train import loop as L

from test_train_loop import make_dataset, tiny_pretrained_dir

TOL = 1e-4
LR = 1e-3
NOISE_LEAF = "encoder.k.bias"
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, num_labels=2)


def _speed(key: str) -> bool:
    return "runtime" in key or "per_second" in key


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """Both packages' run_cross_validation([1], cfg) on one dataset from
    one parameter tree; (tmp, port cfg, port result, JAX result)."""
    import jax
    import jax.numpy as jnp

    tmp = tmp_path_factory.mktemp("loop")
    data_dir = make_dataset(tmp, np.random.default_rng(0))
    jcfg = jast.ASTConfig(**TINY)
    tree = jax.tree.map(np.asarray, jast.init_params(jax.random.PRNGKey(7),
                                                     jcfg))
    common = dict(stage="stage1", data_dir=data_dir, num_epochs=3,
                  batch_size=4, learning_rate=LR, enable_early_stopping=False,
                  augment=False)
    cfg = L.TrainFoldConfig(output_root=str(tmp / "port"),
                            dtype=torch.float32, device="cpu", **common)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JL, "init_model",
                   lambda c: (jax.tree.map(jnp.asarray, tree), jcfg))
        mp.setattr(L, "init_model", lambda c: (
            convert.params_from_jax(tree), ast_mod.ASTConfig(**TINY)))
        want = JL.run_cross_validation([1], JL.TrainFoldConfig(
            output_root=str(tmp / "jax"), dtype=jnp.float32, **common))
        got = L.run_cross_validation([1], cfg)
    return tmp, cfg, got, want


def test_epoch_losses_and_metrics_match_jax(both):
    tmp, _, _, _ = both
    got = json.loads((tmp / "port/fold1/history.json").read_text())
    want = json.loads((tmp / "jax/fold1/history.json").read_text())
    assert [h["epoch"] for h in got] == [h["epoch"] for h in want] == [1, 2, 3]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            assert g[key] == pytest.approx(w[key], abs=TOL), (g, w)


def test_fold_metrics_match_jax(both):
    _, _, got, want = both
    assert set(got["per_fold"][0]) == set(want["per_fold"][0])
    assert set(got["aggregate"]) == set(want["aggregate"])
    for key, value in want["per_fold"][0].items():
        if not _speed(key):
            assert got["per_fold"][0][key] == pytest.approx(value, abs=TOL), key
    assert got["aggregate"]["eval_f1_mean"] > 0.8


def test_best_params_match_jax(both):
    tmp, _, _, _ = both
    got, _ = convert.load_hf_model_dir(str(tmp / "port/fold1/best"))
    want, _ = jconvert.load_hf_model_dir(str(tmp / "jax/fold1/best"))
    got = convert._flatten_tree(convert.params_to_numpy(got))
    want = jconvert._flatten_tree({k: v for k, v in want.items()})
    assert sorted(got) == sorted(want)
    for key in want:
        err = np.abs(got[key] - np.asarray(want[key])).max()
        assert err <= (LR if key == NOISE_LEAF else TOL), (key, err)


def test_artifact_contract(both):
    _, cfg, _, _ = both
    fold_dir = Path(cfg.output_root) / "fold1"
    best = fold_dir / "best"
    assert (best / "model.safetensors").exists()
    assert (best / "config.json").exists()
    assert (best / "preprocessor_config.json").exists()
    mean, std = L.load_feature_extractor_config(str(best))
    assert std > 0
    assert (best / "evaluation_test" / "confusion_matrix.npy").exists()
    assert (best / "evaluation_val" / "classification_report.txt").exists()
    assert (fold_dir / "run_config.json").exists()
    assert (fold_dir / "history.json").exists()
    assert (fold_dir / "best_params.safetensors").exists()
    assert (Path(cfg.output_root) / "cv_metrics.npy").exists()
    assert (Path(cfg.output_root) / "cv_metrics.txt").exists()
    cks = [p for p in fold_dir.iterdir() if p.name.startswith("checkpoint-")]
    assert 1 <= len(cks) <= max(2, (cfg.num_epochs + 1) // 2)
    for ck in cks:  # the JAX package's checkpoint layout
        assert {p.name for p in ck.iterdir()} == {
            "params.safetensors", "opt_state.safetensors", "train_state.json"}


def test_best_dir_loads_in_hf(both):
    transformers = pytest.importorskip("transformers")

    _, cfg, _, _ = both
    best = str(Path(cfg.output_root) / "fold1" / "best")
    model = transformers.ASTForAudioClassification.from_pretrained(best).eval()
    assert model.config.num_labels == 2
    assert model.config.id2label == {0: "Idle", 1: "Swallow"}
    fx = transformers.ASTFeatureExtractor.from_pretrained(best)
    assert fx.mean != -4.2677393  # per-fold stats, not AudioSet default
    params, mcfg = convert.load_hf_model_dir(best)
    x = np.random.default_rng(1).standard_normal(
        (2, mcfg.max_length, mcfg.num_mel_bins)).astype(np.float32)
    with torch.no_grad():
        ours = ast_mod.forward(params, torch.from_numpy(x), mcfg).numpy()
        ref = model(torch.from_numpy(x)).logits.numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-5, rtol=1e-4)


def test_backup_run_dir(tmp_path):
    d = tmp_path / "fold1"
    d.mkdir()
    (d / "old.txt").write_text("x")
    backup = L.backup_existing_run_dir(str(d))
    assert backup and Path(backup).exists()
    assert (Path(backup) / "old.txt").read_text() == "x"
    assert L.backup_existing_run_dir(str(tmp_path / "nope")) is None


def test_dry_run_fast(tmp_path):
    data_dir = make_dataset(tmp_path, np.random.default_rng(3), n_per_class=4,
                            val=False)
    cfg = L.TrainFoldConfig(
        stage="stage2", data_dir=data_dir,
        output_root=str(tmp_path / "runs/stage2"),
        pretrained_model_dir=tiny_pretrained_dir(tmp_path), dry_run=True,
        use_class_weights=True, focal_gamma=2.0, label_smoothing=0.1,
        augment=True, dtype=torch.float32, device="cpu")
    m = L.train_fold(1, cfg)
    assert any(k.startswith("fold1_test_") for k in m)
    assert any(k.startswith("test_") for k in m)  # stage 2's generic names
    fold_dir = Path(cfg.output_root) / "fold1"
    assert not (fold_dir / "best" / "evaluation_test").exists()
    cks = [p for p in fold_dir.iterdir() if p.name.startswith("checkpoint-")]
    assert len(cks) == 1


def test_grad_accum_matches_one_batch(tmp_path):
    """grad_accum=2 of batch 2 is one update per batch of 4 (the same
    samples in the same order, the mean of equal micro-batch means), as
    the JAX loop's accumulation is: the same losses, metrics and best
    parameters up to the order of the sums (the key bias to the learning
    rate, as in test_best_params_match_jax)."""
    data_dir = make_dataset(tmp_path, np.random.default_rng(12),
                            n_per_class=4)
    pretrained = tiny_pretrained_dir(tmp_path)

    def run(batch, accum):
        root = tmp_path / f"b{batch}"
        L.train_fold(1, L.TrainFoldConfig(
            data_dir=data_dir, output_root=str(root),
            pretrained_model_dir=pretrained, num_epochs=2, batch_size=batch,
            grad_accum=accum, learning_rate=LR, enable_early_stopping=False,
            augment=False, dtype=torch.float32, device="cpu"))
        return (json.loads((root / "fold1/history.json").read_text()),
                convert.read_safetensors(str(root / "fold1/best/"
                                             "model.safetensors")))

    (h1, p1), (h2, p2) = run(4, 1), run(2, 2)
    for a, b in zip(h1, h2):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key] == pytest.approx(b[key], abs=TOL), (key, a, b)
    for key in p1:
        err = np.abs(p1[key] - p2[key]).max()
        assert err <= (LR if ".key.bias" in key else TOL), (key, err)


def test_train_fold_runs_with_deterministic_cudnn(tmp_path, monkeypatch):
    """A fold trains under cuDNN's deterministic algorithms (on the card
    the patch convolution's weight gradient would otherwise differ from
    run to run in the last bits, and --resume could not equal a straight
    run); the setting is restored afterwards."""
    from zenker_audio_detection_tpu_torch.train import steps

    seen = []
    make = steps.make_train_step

    def recording(*args, **kw):
        step = make(*args, **kw)

        def run(*step_args):
            seen.append(torch.backends.cudnn.deterministic)
            return step(*step_args)
        return run

    monkeypatch.setattr(steps, "make_train_step", recording)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    data_dir = make_dataset(tmp_path, np.random.default_rng(2), n_per_class=2,
                            val=False)
    L.train_fold(1, L.TrainFoldConfig(
        data_dir=data_dir, output_root=str(tmp_path / "out"),
        pretrained_model_dir=tiny_pretrained_dir(tmp_path), dry_run=True,
        augment=False, dtype=torch.float32, device="cpu"))
    assert seen and all(seen)
    assert torch.backends.cudnn.deterministic is False


def test_streaming_matches_eager_bitwise(tmp_path):
    """TrainFoldConfig.streaming featurizes per batch with background
    prefetch; the metrics and the best parameters are the eager run's bit
    for bit (same per-example augmentation seeds, same batches)."""
    data_dir = make_dataset(tmp_path, np.random.default_rng(9), n_per_class=4)
    pretrained = tiny_pretrained_dir(tmp_path)

    def run(streaming, tag):
        cfg = L.TrainFoldConfig(
            stage="stage1", data_dir=data_dir,
            output_root=str(tmp_path / f"runs_{tag}"),
            pretrained_model_dir=pretrained, num_epochs=2, batch_size=4,
            learning_rate=LR, enable_early_stopping=False, augment=True,
            dtype=torch.float32, device="cpu", streaming=streaming)
        m = L.train_fold(1, cfg)
        best = convert.read_safetensors(str(
            tmp_path / f"runs_{tag}" / "fold1" / "best" / "model.safetensors"))
        return m, best

    (eager, eager_best), (stream, stream_best) = run(False, "e"), run(True, "s")
    assert set(eager) == set(stream)
    for k, v in eager.items():
        if not _speed(k):
            assert stream[k] == v, k
    for k, v in eager_best.items():
        np.testing.assert_array_equal(stream_best[k], v)


def test_feature_stream_gather_matches_eager_rows():
    rng = np.random.default_rng(1)
    entries = [rng.standard_normal(16000).astype(np.float32)
               for _ in range(6)]
    eager = L.featurize_paths(entries, -1.1, 3.5, np.random.default_rng(42),
                              max_frames=128, device="cpu")
    stream = L.FeatureStream(entries, -1.1, 3.5, np.random.default_rng(42),
                             max_frames=128, device="cpu")
    for idx in ([3, 0, 5], [1, 2], [3, 0, 5]):  # repeat: same result
        got = stream.gather(np.asarray(idx))
        np.testing.assert_array_equal(got, eager[np.asarray(idx)])
    stream.prefetch(np.asarray([4, 1]))
    np.testing.assert_array_equal(stream.gather(np.asarray([4, 1])),
                                  eager[[4, 1]])
    stream.close()


@pytest.mark.parametrize("augment", [False, True])
def test_featurize_paths_matches_jax(monkeypatch, augment):
    """Both packages' featurization of the same entries (float32 and int16
    payloads, several lengths, a sub-frame clip), the same augmentation
    seeds (both on the numpy vocoder): 1e-5, and 1e-3 in bins whose power
    is within a factor 1e4 of the log floor, where the f32 DFT sums in
    other orders are magnified by the log (tests/test_golden.py's bound;
    the gap grows smoothly as the power falls: 2e-7 above log-mel 0, 7e-6
    at -7, 7e-5 at -12 here)."""
    for native in (jax_native, port_native):
        monkeypatch.setattr(native, "phase_vocoder_stretch",
                            lambda x, rate: None)
    rng = np.random.default_rng(5)
    entries = [(rng.standard_normal(n) * 0.1).astype(np.float32)
               for n in (16000, 16000, 12345, 300)]
    entries.append((rng.standard_normal(16000) * 3000).astype(np.int16))
    mean, std = -1.1, 3.5

    def seed():
        return np.random.default_rng(42) if augment else None

    got = L.featurize_paths(entries, mean, std, seed(), max_frames=256,
                            device="cpu")
    want = JL.featurize_paths(entries, mean, std, seed(), max_frames=256)
    assert got.shape == want.shape == (5, 256, 128)
    raw = want * 2 * std + mean
    near_floor = raw < np.log(1.192092955078125e-07 * 1e4)
    err = np.abs(got - want)
    assert err[~near_floor].max() <= 1e-5
    assert err.max() <= 1e-3


def test_per_fold_tracking_runs(tmp_path):
    """--wandb-per-fold: one tracking run per fold (grouped) + a cv_summary
    run, with the per-step loss channel, its TensorBoard mirror, the CM
    plot, the report table and the config artifact (tests/test_train_loop.py
    ::test_per_fold_tracking_runs)."""
    data_dir = make_dataset(tmp_path, np.random.default_rng(3), n_per_class=4)
    out = tmp_path / "runs_pf"
    cfg = L.TrainFoldConfig(
        stage="stage1", data_dir=data_dir, output_root=str(out),
        pretrained_model_dir=tiny_pretrained_dir(tmp_path), num_epochs=2,
        batch_size=4, learning_rate=LR, enable_early_stopping=False,
        augment=False, dtype=torch.float32, device="cpu", logging_steps=1)
    L.run_cross_validation([1], cfg, tracking_opts={"enabled": False,
                                                    "per_fold": True})
    tracking_dir = out / "tracking"
    fold_run = next(p for p in tracking_dir.iterdir()
                    if p.name.endswith("_fold1"))
    records = [json.loads(ln) for ln in
               (fold_run / "metrics.jsonl").read_text().splitlines()]
    assert any(r.get("epoch") == 1 and "eval_f1" in r for r in records)
    step_recs = [r for r in records if "train_step_loss" in r]
    assert step_recs and step_recs[0]["train_step"] == 1
    from test_sweep_utils import _read_tb_scalars
    tb = _read_tb_scalars(str(fold_run / "logs"))
    assert [s for s, _ in tb["train_step_loss"]] == \
        [r["train_step"] for r in step_recs]
    assert list((fold_run / "media").glob("*confusion_matrix*"))
    table = json.loads(next((fold_run / "tables").glob(
        "*classification_report*")).read_text())
    assert table["columns"][0] == "class"
    assert [r[0] for r in table["rows"]] == ["Idle", "Swallow", "macro avg",
                                             "weighted avg"]
    assert any((fold_run / "artifacts").glob("run_config*"))
    assert "fold1_test_eval_f1" in json.loads(
        (fold_run / "summary.json").read_text())
    summary_run = next(p for p in tracking_dir.iterdir()
                       if p.name.endswith("_cv_summary"))
    assert "eval_f1_mean" in json.loads(
        (summary_run / "summary.json").read_text())


@pytest.mark.parametrize("kw", [{"num_devices": 2}, {"num_slices": 2},
                                {"fold_parallel": True, "data_per_fold": 2},
                                {"data_per_fold": 2}])
def test_config_refuses_what_is_not_ported(kw):
    """The config takes the fields of several devices as the JAX package's
    does: it stores them and refuses nothing (the trainers validate them,
    tests/test_torch_multidevice.py)."""
    cfg, jcfg = L.TrainFoldConfig(**kw), JL.TrainFoldConfig(**kw)
    for name in ("num_devices", "num_slices", "fold_parallel",
                 "data_per_fold"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    L.TrainFoldConfig(num_devices=1, num_slices=1)  # one device is fine
    L.TrainFoldConfig(fold_parallel=True)


def test_loop_needs_cuda_unless_the_cpu_is_named(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = L.TrainFoldConfig(output_root=str(tmp_path / "out"))
    assert cfg.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        L.run_cross_validation([1], cfg)
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        L.featurize_paths([np.zeros(16000, np.float32)], 0.0, 1.0)


def test_init_model(tmp_path):
    """Random init deterministic in the seed; an HF dir gets a fresh
    2-class head and, with max_length, adapted position embeddings; an
    int8 export is refused as the JAX trainer refuses it."""
    a, acfg = L.init_model(L.TrainFoldConfig(seed=3, max_length=128))
    b, _ = L.init_model(L.TrainFoldConfig(seed=3, max_length=128))
    assert acfg.num_labels == 2 and acfg.max_length == 128
    for (_, x), (_, y) in zip(convert._flatten_tree(a).items(),
                              convert._flatten_tree(b).items()):
        assert torch.equal(x, y)
    pretrained = tiny_pretrained_dir(tmp_path)
    params, mcfg = L.init_model(L.TrainFoldConfig(
        pretrained_model_dir=pretrained, max_length=128))
    assert mcfg.num_labels == 2 and mcfg.max_length == 128
    assert params["head"]["dense"]["kernel"].shape == (32, 2)
    assert params["pos_embed"].shape == (1, mcfg.seq_length, 32)
    (Path(pretrained) / "model_int8.safetensors").write_bytes(b"")
    with pytest.raises(ValueError, match="int8"):
        L.init_model(L.TrainFoldConfig(pretrained_model_dir=pretrained))


@pytest.mark.parametrize("cli", [cli_s1, cli_s2, cli_stats])
def test_cli_help(cli, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--help"])
    assert e.value.code == 0
    assert "--device" in capsys.readouterr().out


@pytest.mark.parametrize("cli,stage", [(cli_s1, "stage1"),
                                       (cli_s2, "stage2")])
def test_cli_dry_run_on_the_cpu(tmp_path, cli, stage):
    data_dir = make_dataset(tmp_path, np.random.default_rng(4), n_per_class=4)
    out = tmp_path / "runs"
    cli.main(["--fold", "1", "--data-dir", data_dir, "--output-root",
              str(out), "--pretrained-model-dir", tiny_pretrained_dir(tmp_path),
              "--dry-run", "--f32", "--no-augment", "--no-wandb",
              "--device", "cpu"])
    assert (out / "fold1" / "best" / "model.safetensors").exists()
    cv = np.load(out / "cv_metrics.npy", allow_pickle=True).item()
    assert "eval_f1_mean" in cv["aggregate"]
    config = json.loads(next(out.glob("run_config_*.json")).read_text())
    assert config["stage"] == stage and config["dry_run"] is True


def test_compute_stats_cli_on_the_cpu(tmp_path):
    data_dir = Path(make_dataset(tmp_path, np.random.default_rng(6),
                                 n_per_class=2))
    cli_stats.main(["--data-dir", str(data_dir), "--folds", "1",
                    "--device", "cpu"])
    per_fold = json.loads((data_dir / "stats_per_fold.json").read_text())
    assert per_fold[0]["fold"] == 1 and per_fold[0]["count"] > 0


@pytest.mark.parametrize("flags,exc,match", [
    (["--num-devices", "2"], RuntimeError,
     "missing train/test npy files for fold 1 in data_ast_stage1"),
    (["--num-slices", "2"], SystemExit,
     "--num-devices must be a multiple of --num-slices"),
    (["--parallel-folds", "--data-per-fold", "2"], SystemExit,
     "--data-per-fold requires an explicit --num-devices"),
    (["--data-per-fold", "2"], SystemExit,
     "--data-per-fold requires --parallel-folds")])
def test_cli_refuses_what_is_not_ported(tmp_path, monkeypatch, flags, exc,
                                        match):
    """What the JAX trainer does with the same flags: its validation's
    SystemExit, or, for --num-devices 2, the training itself, which here
    runs on two ranks and fails in each on the missing default data dir
    (JAX's FileNotFoundError, reported by the launcher)."""
    from zenker_audio_detection_tpu.cli import train_stage1 as jcli

    monkeypatch.chdir(tmp_path)
    argv = ["--output-root", str(tmp_path / "runs"), "--max-length", "128",
            *flags]
    with pytest.raises(exc, match=match):
        cli_s1.main(["--device", "cpu", *argv])
    if exc is SystemExit:
        with pytest.raises(SystemExit, match=match):
            jcli.main(argv)


@pytest.mark.parametrize("argv", [
    ["--fold", "1", "--data-dir", "{d}", "--output-root", "{d}/out"],
    ["--data-dir", "{d}", "--folds", "1"],
])
def test_cli_without_device_needs_cuda(tmp_path, monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cli = cli_s1 if "--fold" in argv else cli_stats
    data_dir = make_dataset(tmp_path, np.random.default_rng(8), n_per_class=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([a.replace("{d}", data_dir) for a in argv])
