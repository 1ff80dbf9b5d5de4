"""The port's cli/adapt_checkpoint.py against the JAX package's, on one
1024-frame model directory written by JAX's `save_hf_model_dir` (random
position embeddings, so that the cut changes the scores) and one val
split of one-second clips. The port runs with --device cpu.

Tolerances: the output directories are equal (every safetensors tensor
bit for bit, config.json and preprocessor_config.json byte for byte), for
the HF export, the int8 export and both; the ranking-drift check prints
the same AUCs to 4 places (the f32 scores of the two packages differ by
~1e-7; the test checks that no two of them lie within 1e-5 of each
other) and refuses, or exports, at the same --max-drift."""

import contextlib
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.analysis import roc_pr as jroc
from zenker_audio_detection_tpu.audio import io as jaio
from zenker_audio_detection_tpu.cli import adapt_checkpoint as jadapt
from zenker_audio_detection_tpu.models import ast as jast
from zenker_audio_detection_tpu.models import convert as jconvert
from zenker_audio_detection_tpu.train import loop as jtrain_loop
from zenker_audio_detection_tpu_torch.cli import adapt_checkpoint
from zenker_audio_detection_tpu_torch.models import convert

SCORE_GAP = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("adapt")
    cfg = jast.ASTConfig(hidden_size=16, num_hidden_layers=1,
                         num_attention_heads=2, intermediate_size=32,
                         num_labels=2)
    params = jax.tree.map(np.asarray,
                          jast.init_params(jax.random.PRNGKey(4), cfg))
    # random position, CLS and DIST embeddings and 10x the init's encoder
    # and patch kernels, so that the scores depend on the clip and the cut
    # of the position embeddings moves them (a random init scores every
    # clip within ~1e-4 of the others)
    r = np.random.default_rng(5)
    for key in ("pos_embed", "cls_token", "dist_token"):
        params[key] = r.standard_normal(params[key].shape).astype(np.float32)
    for leaf in [*params["encoder"].values(), params["patch_embed"]]:
        if "kernel" in leaf:
            leaf["kernel"] = leaf["kernel"] * 10.0
    head = params["head"]["dense"]
    head["kernel"] = r.standard_normal(head["kernel"].shape).astype(
        np.float32)
    src = root / "src"
    jconvert.save_hf_model_dir(params, cfg, str(src),
                               {0: "Idle", 1: "Swallow"})
    jtrain_loop.save_feature_extractor_config(str(src), -1.15, 3.53)
    r = np.random.default_rng(4)
    data = root / "data_ast_stage1"
    data.mkdir()
    xs, ys = [], []
    for i in range(16):
        label = i % 2
        p = root / "wav" / f"c{i}.wav"
        p.parent.mkdir(exist_ok=True)
        # amplitudes spread over decades: noise clips of one amplitude
        # give nearly one score
        amp = 10 ** r.uniform(-2.5, -0.5) * (1 + 2 * label)
        jaio.write_wav(str(p), (r.standard_normal(16000) * amp).astype(
            np.float32), 16000, dtype="float32")
        xs.append(str(p))
        ys.append(label)
    np.save(data / "val_x_fold1.npy", np.asarray(xs, object))
    np.save(data / "val_y_fold1.npy", np.asarray(ys))
    return root, src, data


def assert_same_dir(got, want):
    assert sorted(os.listdir(got)) == sorted(os.listdir(want))
    for name in os.listdir(want):
        g, w = os.path.join(got, name), os.path.join(want, name)
        if name.endswith(".safetensors"):
            a, b = convert.read_safetensors(g), convert.read_safetensors(w)
            assert sorted(a) == sorted(b)
            for k in b:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            with open(g, "rb") as f1, open(w, "rb") as f2:
                assert f1.read() == f2.read(), name


@pytest.mark.parametrize("flags", [["--max-length", "128"], ["--int8"],
                                   ["--max-length", "128", "--int8"],
                                   ["--max-length", "1024"]])
def test_output_dir_equals_jax(assets, tmp_path, capsys, flags):
    _, src, _ = assets
    adapt_checkpoint.main([str(src), str(tmp_path / "ours"), *flags,
                           "--no-drift-check", "--device", "cpu"])
    ours = capsys.readouterr().out
    jadapt.main([str(src), str(tmp_path / "jax"), *flags, "--no-drift-check"])
    assert capsys.readouterr().out.replace(str(tmp_path / "jax"), "X") == \
        ours.replace(str(tmp_path / "ours"), "X")
    assert_same_dir(tmp_path / "ours", tmp_path / "jax")
    _, cfg = convert.load_hf_model_dir(str(tmp_path / "ours"))
    assert cfg.max_length == (128 if "128" in flags else 1024)


def _drift_line(text):
    lines = [x for x in text.splitlines() if "ranking drift on" in x]
    assert len(lines) == 1, text
    m = re.search(r"AUC (\S+) -> (\S+) \(drift (\S+)\)", lines[0])
    return lines[0].split(" on ", 1)[1].split(": ", 1)[1], float(m.group(3))


@pytest.fixture(scope="module")
def drift(assets):
    """(the port's drift line, JAX's, the drift) at the default
    --max-drift; both scored sides spread out by more than SCORE_GAP."""
    root, src, data = assets
    paths = np.load(data / "val_x_fold1.npy", allow_pickle=True).tolist()
    jparams, jcfg = jconvert.load_hf_model_dir(str(src))
    for p, c in ((jparams, jcfg),
                 jast.adapt_max_length(jparams, jcfg, 128)):
        s = jroc.positive_scores_from_params(p, c, -1.15, 3.53, paths,
                                             dtype=jnp.float32)
        gap = np.diff(np.sort(s)).min()
        assert gap > SCORE_GAP, (
            f"two scores lie {gap:.2e} apart, under {SCORE_GAP}: their "
            f"order may differ between the packages")
    lines = []
    for mod, extra in ((adapt_checkpoint, ["--device", "cpu"]),
                       (jadapt, [])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main([str(src), str(root / f"probe_{len(lines)}"),
                      "--max-length", "128", "--drift-data", str(data),
                      "--allow-drift", "--max-drift", "-1", *extra])
        lines.append(_drift_line(buf.getvalue()))
    assert lines[0] == lines[1]
    return lines[0][1]


@pytest.mark.parametrize("side", ["below", "above"])
def test_drift_refusal_at_same_max_drift(assets, drift, tmp_path, capsys,
                                         side):
    """Just below the measured drift both refuse (exit 1, no artifact);
    just above it both export."""
    _, src, data = assets
    max_drift = drift - 0.005 if side == "below" else drift + 0.005
    results = []
    for name, mod, extra in (("ours", adapt_checkpoint, ["--device", "cpu"]),
                             ("jax", jadapt, [])):
        out = tmp_path / name
        argv = [str(src), str(out), "--max-length", "128", "--drift-data",
                str(data), "--max-drift", str(max_drift), *extra]
        if side == "below":
            with pytest.raises(SystemExit) as e:
                mod.main(argv)
            assert e.value.code == 1
            err = capsys.readouterr().err
            assert "exceeds --max-drift" in err and "fine-tune" in err
            assert not out.exists()
        else:
            mod.main(argv)
            assert (out / "model.safetensors").exists()
        results.append(out.exists())
    assert results[0] == results[1]
    if side == "above":
        assert_same_dir(tmp_path / "ours", tmp_path / "jax")


def test_drift_data_discovered_from_cwd(assets, tmp_path, monkeypatch,
                                        capsys):
    """Without --drift-data the check finds data_ast_stage1/ in the
    working directory from the model's id2label, as JAX's does."""
    root, src, _ = assets
    monkeypatch.chdir(root)
    adapt_checkpoint.main([str(src), str(tmp_path / "o"), "--max-length",
                           "128", "--allow-drift", "--device", "cpu"])
    assert "ranking drift on data_ast_stage1" in capsys.readouterr().out


def test_refusals_equal_jax(assets, tmp_path):
    _, src, _ = assets
    with pytest.raises(SystemExit):
        adapt_checkpoint.main([str(src), str(tmp_path / "o"),
                               "--device", "cpu"])
    i8 = tmp_path / "i8"
    adapt_checkpoint.main([str(src), str(i8), "--int8", "--device", "cpu"])
    with pytest.raises(SystemExit):  # an int8 source needs --int8
        adapt_checkpoint.main([str(i8), str(tmp_path / "o2"),
                               "--max-length", "128", "--device", "cpu"])
    with pytest.raises(SystemExit):
        jadapt.main([str(i8), str(tmp_path / "o3"), "--max-length", "128"])


def test_transformers_loads_the_adapted_dir(assets, tmp_path):
    transformers = pytest.importorskip("transformers")
    _, src, _ = assets
    adapt_checkpoint.main([str(src), str(tmp_path / "o"), "--max-length",
                           "128", "--no-drift-check", "--device", "cpu"])
    model = transformers.ASTForAudioClassification.from_pretrained(
        str(tmp_path / "o")).eval()
    assert model.config.max_length == 128
    fx = json.loads((tmp_path / "o" / "preprocessor_config.json").read_text())
    assert fx["max_length"] == 128 and fx["mean"] == -1.15
