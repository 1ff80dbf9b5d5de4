"""The port's two-stage engine and CLI against the JAX package's engine,
CLI and the frozen cascade goldens (tests/golden/cascade_golden.npz)."""

import json
import os

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.infer import cascade as JC
from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu_torch.audio import io as aio
from zenker_audio_detection_tpu_torch.infer import cascade as C
from zenker_audio_detection_tpu_torch.models import ast as ast_mod
from zenker_audio_detection_tpu_torch.models import convert

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# tests/test_golden.py's cascade config
CASCADE_CFG = dict(hidden_size=16, num_hidden_layers=1, num_attention_heads=2,
                   intermediate_size=32, max_length=256, num_labels=2)
SMALL = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
             intermediate_size=64, max_length=128, num_labels=2)


def _unflatten(flat):
    tree = {}
    for key, arr in flat.items():
        node = tree
        *path, leaf = key.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return tree


def _json_close(got, want, path="$"):
    """tests/test_golden.py's comparison: structure, strings and ints
    exact, floats to 1e-5."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _json_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _json_close(a, b, f"{path}[{i}]")
    elif want is None or isinstance(want, (bool, str)):
        assert got == want, (path, got, want)
    elif isinstance(want, int) and isinstance(got, int):
        assert got == want, (path, got, want)
    else:
        assert abs(float(got) - float(want)) < 1e-5, (path, got, want)


@pytest.fixture(scope="module")
def cascade_golden():
    return np.load(os.path.join(GOLDEN, "cascade_golden.npz"))


@pytest.fixture(scope="module")
def golden_engine(cascade_golden):
    g = cascade_golden
    cfg = ast_mod.ASTConfig(**CASCADE_CFG)
    p1 = convert.params_from_jax(
        _unflatten({k[3:]: g[k] for k in g.files if k.startswith("s1.")}))
    p2 = convert.params_from_jax(
        _unflatten({k[3:]: g[k] for k in g.files if k.startswith("s2.")}))
    s1 = C.StageSpec(p1, cfg, -1.15, 3.53, ("Idle", "Swallow"))
    s2 = C.StageSpec(p2, cfg, -0.9, 2.8, ("Healthy", "Zenker"))
    return C.TwoStageEngine(
        s1, s2, C.CascadeConfig(batch_size=16, dtype=torch.float32),
        device="cpu")


@pytest.mark.parametrize("tag", ["a", "b"])
def test_window_probs_match_golden(cascade_golden, golden_engine, tag):
    g = cascade_golden
    s1_probs, s2_probs = golden_engine.window_probs(g[f"audio_{tag}"])
    assert s1_probs.dtype == s2_probs.dtype == np.float64
    np.testing.assert_allclose(s1_probs, g[f"s1_probs_{tag}"], atol=1e-5)
    np.testing.assert_allclose(s2_probs, g[f"s2_probs_{tag}"], atol=1e-5)


def test_patient_json_matches_golden(cascade_golden, golden_engine):
    g = cascade_golden
    want = json.loads(g["patient_json"].item().decode())
    got = json.loads(json.dumps(golden_engine.run_patient(
        ["a.wav", "b.wav"], [g["audio_a"], g["audio_b"]],
        "s1_root", "s2_root"), sort_keys=True))
    _json_close(got, want)


def _stage_trees():
    """Two JAX-layout stage pytrees with random heads. The seeds and head
    biases are picked so that, on `audio`, the Stage-1 gate passes some
    windows and not others and Stage 2 calls both classes, every window
    more than 1e-4 (ten times the parity bound) from each threshold."""
    import jax

    cfg = jast.ASTConfig(**SMALL)
    trees = []
    for seed, shift in ((8, 1.6), (4, 0.1)):
        tree = jax.tree.map(np.asarray, jast.init_params(
            jax.random.PRNGKey(seed), cfg))
        rng = np.random.default_rng(seed)
        tree["pos_embed"] = (0.1 * rng.standard_normal(
            tree["pos_embed"].shape)).astype(np.float32)
        tree["head"]["dense"]["kernel"] = rng.standard_normal(
            tree["head"]["dense"]["kernel"].shape).astype(np.float32)
        tree["head"]["dense"]["bias"] = np.array([0.0, shift], np.float32)
        trees.append(tree)
    return cfg, trees


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(11)
    t = np.arange(16000 * 6) / 16000.0
    x = 0.05 * rng.standard_normal(t.shape) * (1.0 + np.sin(2 * np.pi * 0.7 * t))
    return (x * 32768).clip(-32768, 32767).astype(np.int16)


@pytest.mark.parametrize("hop_sec", [0.5, 0.503])  # frame grid / off grid
@pytest.mark.parametrize("mode", ["gated", "all"])
def test_engine_matches_jax_engine(audio, hop_sec, mode):
    import jax.numpy as jnp

    jcfg, trees = _stage_trees()
    cfg = ast_mod.ASTConfig(**SMALL)
    common = dict(hop_sec=hop_sec, batch_size=4, stage2_mode=mode,
                  stage1_threshold=0.55, stage1_forward_min_prob=0.6)
    jengine = JC.TwoStageEngine(
        JC.StageSpec(trees[0], jcfg, -1.2, 3.5, ("Idle", "Swallow")),
        JC.StageSpec(trees[1], jcfg, -0.9, 2.8, ("Healthy", "Zenker")),
        JC.CascadeConfig(dtype=jnp.float32, **common))
    engine = C.TwoStageEngine(
        C.StageSpec(convert.params_from_jax(trees[0]), cfg, -1.2, 3.5,
                    ("Idle", "Swallow")),
        C.StageSpec(convert.params_from_jax(trees[1]), cfg, -0.9, 2.8,
                    ("Healthy", "Zenker")),
        C.CascadeConfig(dtype=torch.float32, **common), device="cpu")
    assert engine._frame_reuse == (hop_sec == 0.5)
    want1, want2 = jengine.window_probs(audio)
    got1, got2 = engine.window_probs(audio)
    np.testing.assert_allclose(got1, want1, atol=1e-5)
    np.testing.assert_allclose(got2, want2, atol=1e-5)
    gated = engine._gate_indices(got1)
    assert 0 < len(gated) < len(got1), "the gate should split the windows"
    for p, thresholds in ((got1, (0.5, 0.55, 0.6)), (got2[gated], (0.5,))):
        margin = np.abs(p[:, 1][:, None] - np.asarray(thresholds)).min()
        assert margin > 1e-4, "a window sits on a threshold"
    np.testing.assert_array_equal(gated, jengine._gate_indices(want1))
    summary, preds, _, aligned = engine.gate_and_summarize(got1, got2)
    jsummary, jpreds, _, jaligned = jengine.gate_and_summarize(want1, want2)
    np.testing.assert_array_equal(preds, jpreds)
    np.testing.assert_array_equal(aligned, jaligned)
    _json_close(json.loads(json.dumps(summary)),
                json.loads(json.dumps(jsummary)))


def test_short_recording_gets_one_padded_window():
    _, trees = _stage_trees()
    cfg = ast_mod.ASTConfig(**SMALL)
    spec = C.StageSpec(convert.params_from_jax(trees[0]), cfg, 0.0, 1.0,
                       ("Idle", "Swallow"))
    engine = C.TwoStageEngine(spec, spec, C.CascadeConfig(
        dtype=torch.float32, stage2_mode="all"), device="cpu")
    p1, p2 = engine.window_probs(np.zeros(5000, np.float32))
    assert p1.shape == p2.shape == (1, 2)
    np.testing.assert_allclose(p1.sum(axis=1), 1.0, atol=1e-6)


def test_engine_rejects_unknown_modes():
    _, trees = _stage_trees()
    cfg = ast_mod.ASTConfig(**SMALL)
    spec = C.StageSpec(convert.params_from_jax(trees[0]), cfg, 0.0, 1.0,
                       ("Idle", "Swallow"))
    with pytest.raises(ValueError, match="stage2_mode"):
        C.TwoStageEngine(spec, spec, C.CascadeConfig(stage2_mode="some"),
                         device="cpu")
    with pytest.raises(ValueError, match="attention_impl"):
        C.TwoStageEngine(spec, spec, C.CascadeConfig(attention_impl="pallas"),
                         device="cpu")


def test_frame_cache_round_trip(tmp_path, audio):
    _, trees = _stage_trees()
    cfg = ast_mod.ASTConfig(**SMALL)
    spec = C.StageSpec(convert.params_from_jax(trees[0]), cfg, 0.0, 1.0,
                       ("Idle", "Swallow"))
    wav = tmp_path / "rec.wav"
    aio.write_wav(str(wav), audio.astype(np.float32) / 32768.0, 16000)
    engine = C.TwoStageEngine(spec, spec, C.CascadeConfig(
        dtype=torch.float32, cache_dir=str(tmp_path / "cache")), device="cpu")
    pcm = aio.load_audio_compact(str(wav))
    np.testing.assert_array_equal(pcm, audio)
    first = engine.window_probs(pcm, str(wav))
    assert len(os.listdir(tmp_path / "cache")) == 1
    second = engine.window_probs(pcm, str(wav))
    for a, b in zip(first, second):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_cli_json_matches_jax_cli(tmp_path, audio):
    from zenker_audio_detection_tpu.cli import infer_long_audio as jcli
    from zenker_audio_detection_tpu_torch.cli import infer_long_audio as cli
    from zenker_audio_detection_tpu_torch.train import loop as train_loop

    _, trees = _stage_trees()
    cfg = ast_mod.ASTConfig(**SMALL)
    roots = []
    for k, (tree, (mean, std)) in enumerate(zip(trees, [(-1.2, 3.5),
                                                        (-0.9, 2.8)])):
        root = tmp_path / f"stage{k + 1}"
        convert.save_hf_model_dir(convert.params_from_jax(tree), cfg,
                                  str(root))
        train_loop.save_feature_extractor_config(str(root), mean, std,
                                                 max_length=cfg.max_length)
        roots.append(str(root))
    patient = tmp_path / "data" / "Zenker" / "P007"
    patient.mkdir(parents=True)
    aio.write_wav(str(patient / "rec_a.wav"),
                  audio.astype(np.float32) / 32768.0, 16000)
    aio.write_wav(str(patient / "rec_b.wav"),
                  audio[::-1][:16000 * 4].astype(np.float32) / 32768.0, 16000)
    common = ["--patient-id", "P007", "--long-audio-root",
              str(tmp_path / "data"), "--stage1-model-root", roots[0],
              "--stage2-model-root", roots[1], "--f32", "--disable-cache",
              "--batch-size", "8", "--stage1-threshold", "0.55"]
    cli.main(common + ["--device", "cpu",
                       "--output-json", str(tmp_path / "port.json")])
    jcli.main(common + ["--output-json", str(tmp_path / "jax.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got["aggregate"]["total_windows"] == 11 + 7
    assert got["aggregate"]["total_swallow_windows_evaluated_stage2"] > 0
    _json_close(got, want)
