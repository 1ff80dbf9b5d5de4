"""The port's per-fold normalization statistics (`data/stats.py`) against the
JAX package's on the same WAV folds (tests/test_data_stats.py's layout): the
mean and std at rtol 1e-5 (the log-mel frames agree to ~1e-5 and the f64
sums over them average that out), the element counts and the pooled
aggregate exactly, and the three-level normalization fallback identically,
its typed errors included. The port's log-mel runs on the CPU here
(`device="cpu"`); without it CUDA is required."""

import json

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.audio import io as aio
from zenker_audio_detection_tpu.data import stats as JS
from zenker_audio_detection_tpu_torch.data import stats as S

RTOL = 1e-5


@pytest.fixture(scope="module")
def wav_fold_dir(tmp_path_factory):
    """Fold 1: four 1 s clips; fold 2: two of them; fold 3: clips of other
    lengths (two length buckets, one sub-frame clip)."""
    tmp = tmp_path_factory.mktemp("stats")
    rng = np.random.default_rng(0)
    d = tmp / "data"
    d.mkdir()
    paths = []
    for i, n in enumerate([16000] * 4 + [12000, 12000, 300]):
        p = tmp / f"clip{i}.wav"
        aio.write_wav(str(p), (rng.standard_normal(n) * 0.1
                               ).astype(np.float32), 16000, dtype="float32")
        paths.append(str(p))
    np.save(d / "train_x_fold1.npy", np.asarray(paths[:4], dtype=object))
    np.save(d / "train_x_fold2.npy", np.asarray(paths[:2], dtype=object))
    np.save(d / "train_x_fold3.npy", np.asarray(paths[2:], dtype=object))
    return d


@pytest.mark.parametrize("fold", [1, 2, 3])
def test_fold_stats_match_jax(wav_fold_dir, fold):
    ours = S.compute_fold_stats(str(wav_fold_dir), fold, device="cpu")
    want = JS.compute_fold_stats(str(wav_fold_dir), fold)
    assert ours["fold"] == want["fold"] and ours["count"] == want["count"]
    np.testing.assert_allclose(ours["mean"], want["mean"], rtol=RTOL)
    np.testing.assert_allclose(ours["std"], want["std"], rtol=RTOL)


def test_compute_all_writes_the_jax_artifacts(wav_fold_dir, tmp_path):
    per_fold, agg = S.compute_all_stats(str(wav_fold_dir), str(tmp_path / "p"),
                                        num_folds=3, device="cpu")
    j_per_fold, j_agg = JS.compute_all_stats(str(wav_fold_dir),
                                             str(tmp_path / "j"), num_folds=3)
    for name in ("stats_per_fold.json", "stats_aggregate.json",
                 "stats_all.npz"):
        assert (tmp_path / "p" / name).exists()
    loaded = json.loads((tmp_path / "p" / "stats_per_fold.json").read_text())
    assert [e["fold"] for e in loaded] == [1, 2, 3]
    assert agg["total_count"] == j_agg["total_count"] == sum(
        e["count"] for e in loaded)
    for key in ("mean", "std"):
        np.testing.assert_allclose(agg[key], j_agg[key], rtol=RTOL)
        np.testing.assert_allclose([e[key] for e in per_fold],
                                   [e[key] for e in j_per_fold], rtol=RTOL)


def test_empty_fold_gives_zero_counts(tmp_path):
    np.save(tmp_path / "train_x_fold1.npy", np.asarray([], dtype=object))
    assert S.compute_fold_stats(str(tmp_path), 1, device="cpu") == \
        JS.compute_fold_stats(str(tmp_path), 1)


def test_missing_fold_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="Missing fold 1"):
        S.compute_fold_stats(str(tmp_path), 1, device="cpu")


def test_fold_stats_need_cuda_unless_the_cpu_is_named(wav_fold_dir,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        S.compute_fold_stats(str(wav_fold_dir), 1)


@pytest.mark.parametrize("per_fold", [
    [{"fold": 1, "mean": 1.0, "std": 2.0, "count": 100},
     {"fold": 2, "mean": -1.0, "std": 1.0, "count": 50}],
    [{"fold": 1, "mean": 0.5, "std": 0.0, "count": 1},
     {"fold": 2, "mean": 0.0, "std": 0.0, "count": 0}],
    [{"fold": 1, "mean": 0.0, "std": 0.0, "count": 0}],
])
def test_aggregate_matches_jax(per_fold):
    assert S.aggregate_stats(per_fold) == JS.aggregate_stats(per_fold)


def _normalization(module, path, fold):
    try:
        return module.load_fold_normalization(str(path), fold)
    except ValueError as e:
        return type(e), str(e)


@pytest.mark.parametrize("files", [
    {},
    {"stats_aggregate.json": {"mean": -2.0, "std": 3.0, "total_count": 10}},
    {"stats_aggregate.json": {"mean": -2.0, "std": 3.0, "total_count": 0}},
    {"stats_aggregate.json": {"mean": -2.0, "std": 3.0, "total_count": 10},
     "stats_per_fold.json": [{"fold": 1, "mean": -1.0, "std": 2.0,
                              "count": 5}]},
    {"stats_per_fold.json": [{"fold": 1, "mean": -1.0, "std": 2.0,
                              "count": 0}]},
    {"stats_per_fold.json": [{"fold": 1, "mean": "x", "std": 2.0,
                              "count": 5}]},
    {"stats_per_fold.json": [{"fold": 1, "mean": -1.0, "std": 2.0,
                              "count": "5"}]},
    {"stats_per_fold.json": {"fold": 1}},
    {"stats_aggregate.json": [1, 2]},
])
@pytest.mark.parametrize("fold", [1, 2])
def test_load_fold_normalization_fallbacks_match_jax(tmp_path, files, fold):
    """per-fold -> aggregate -> default, and the typed errors of malformed
    files, as the JAX function resolves them."""
    for name, obj in files.items():
        (tmp_path / name).write_text(json.dumps(obj))
    assert _normalization(S, tmp_path, fold) == \
        _normalization(JS, tmp_path, fold)
