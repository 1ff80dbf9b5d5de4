"""The port's quality-drift benchmark (analysis/drift_bench.py,
cli/drift.py), mirroring tests/test_drift_cli.py: the band logic and its
edges, one JSON line from a stubbed run with the exit code, and the
cleanup of the temporary working directory. The full 2x12-epoch run is a
card measurement, not a tier-1 test.

Also against the JAX module: the pins and bands are its values, the band
verdicts equal its `in_band` on a grid of results, and the corpus
builders write the same files byte for byte. Tolerance: none."""

import json
import os

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.analysis import drift_bench as jdrift
from zenker_audio_detection_tpu_torch.analysis import drift_bench
from zenker_audio_detection_tpu_torch.cli import drift as drift_cli


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _good_results():
    return {
        "stage1_auc_f32": drift_bench.PIN_S1_F32,
        "stage1_auc_int8": drift_bench.PIN_S1_F32 + 0.004,
        "stage1_auc_short": 0.70,
        "stage2_auc_f32": drift_bench.PIN_S2_F32,
        "stage2_auc_int8": drift_bench.PIN_S2_F32 - 0.002,
        "stage2_auc_short": drift_bench.PIN_S2_F32,
        "patient_acc_f32": drift_bench.PIN_PATIENT_F32,
        "patient_acc_int8": drift_bench.PIN_PATIENT_F32,
    }


def test_pins_and_bands_are_jax_values():
    for name in ("PIN_S1_F32", "PIN_S2_F32", "PIN_PATIENT_F32", "BAND_AUC",
                 "N_OVERLAP_PATIENTS", "BAND_PATIENT", "BAND_PATIENT_INT8"):
        assert getattr(drift_bench, name) == getattr(jdrift, name), name


def test_in_band_passes_and_discriminates():
    checks = drift_bench.in_band(_good_results())
    assert all(checks.values()), checks
    cases = {
        "s1_f32_pin": ("stage1_auc_f32", drift_bench.PIN_S1_F32 + 0.04),
        "s2_f32_pin": ("stage2_auc_f32", drift_bench.PIN_S2_F32 - 0.04),
        "s1_int8_delta": ("stage1_auc_int8",
                          drift_bench.PIN_S1_F32 + 0.02),
        "s2_short_delta": ("stage2_auc_short",
                           drift_bench.PIN_S2_F32 - 0.02),
        "s1_short_floor": ("stage1_auc_short", 0.55),
        "patient_int8_delta": ("patient_acc_int8",
                               drift_bench.PIN_PATIENT_F32
                               - drift_bench.BAND_PATIENT_INT8 - 0.01),
    }
    for check_name, (key, bad_value) in cases.items():
        r = _good_results()
        r[key] = bad_value
        assert not drift_bench.in_band(r)[check_name], (check_name, r)
    r = _good_results()
    r["patient_acc_f32"] = r["patient_acc_int8"] = 1.0
    assert not drift_bench.in_band(r)["patient_nonsaturated"]


def test_band_edges_inclusive():
    r = _good_results()
    r["patient_acc_f32"] = (drift_bench.PIN_PATIENT_F32
                            + drift_bench.BAND_PATIENT)
    r["patient_acc_int8"] = (r["patient_acc_f32"]
                             - drift_bench.BAND_PATIENT_INT8)
    checks = drift_bench.in_band(r)
    assert checks["patient_pin"] and checks["patient_int8_delta"], checks


@pytest.mark.parametrize("seed", range(4))
def test_in_band_equals_jax(seed):
    """Random results around the pins (inside and outside every band)."""
    r = np.random.default_rng(seed)
    base = _good_results()
    for _ in range(200):
        res = {k: float(v + r.normal(0, 0.03)) for k, v in base.items()}
        if r.random() < 0.1:
            res["patient_acc_f32"] = 1.0
        assert drift_bench.in_band(res) == jdrift.in_band(res)


def test_cli_one_json_line_and_exit(monkeypatch, capsys, tmp_path):
    results = _good_results()
    seen = []

    def fake_run(wd, device):
        seen.append(device)
        return results, drift_bench.in_band(results)

    monkeypatch.setattr(drift_bench, "run", fake_run)
    drift_cli.main(["--cpu", "--workdir", str(tmp_path / "wd")])
    out = capsys.readouterr().out
    lines = [x for x in out.splitlines() if x.strip()]
    assert len(lines) == 1, out
    payload = json.loads(lines[0])
    assert payload["metric"] == "quality_drift_patient_accuracy"
    assert payload["value"] == results["patient_acc_f32"]
    assert payload["in_band"] is True
    assert payload["pins"]["patient_acc"] == drift_bench.PIN_PATIENT_F32
    assert payload["backend"] == "cpu" and seen == ["cpu"]
    assert set(payload["checks"]) == set(drift_bench.in_band(results))
    drift_cli.main(["--device", "cpu", "--workdir", str(tmp_path / "wd1")])
    capsys.readouterr()
    assert seen == ["cpu", "cpu"]

    bad = dict(results, stage1_auc_f32=0.5)
    monkeypatch.setattr(drift_bench, "run",
                        lambda wd, device: (bad, drift_bench.in_band(bad)))
    with pytest.raises(SystemExit) as e:
        drift_cli.main(["--cpu", "--workdir", str(tmp_path / "wd2")])
    assert e.value.code == 1
    captured = capsys.readouterr()
    lines = [x for x in captured.out.splitlines() if x.strip()]
    assert len(lines) == 1
    assert json.loads(lines[0])["in_band"] is False
    assert "s1_f32_pin" in captured.err


def test_cli_temp_workdir_cleanup(monkeypatch):
    seen = {}

    def fake_run(wd, device):
        seen["wd"] = wd
        raise RuntimeError("boom")

    monkeypatch.setattr(drift_bench, "run", fake_run)
    with pytest.raises(RuntimeError):
        drift_cli.main(["--cpu"])
    assert "zenker_drift_" in seen["wd"]
    assert not os.path.exists(seen["wd"])


def test_cli_without_device_needs_cuda(monkeypatch, tmp_path):
    """The default device is the card: without one the CLI raises before
    it makes a working directory or runs anything."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without CUDA")
    monkeypatch.setattr(drift_bench, "run", lambda wd, device: 1 / 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        drift_cli.main(["--workdir", str(tmp_path / "wd")])
    assert not (tmp_path / "wd").exists()


def _files(root):
    return {os.path.relpath(os.path.join(d, f), root):
            open(os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(root) for f in fs
            if not f.endswith(".npy")}


def test_corpus_builders_equal_jax(tmp_path):
    """The training corpus, the overlap eval corpora and the overlap long
    tree are the JAX module's, byte for byte (the eval split npys hold
    each run's own paths, so they are compared with the root replaced)."""
    for name, mod in (("ours", drift_bench), ("jax", jdrift)):
        wd = tmp_path / name
        wd.mkdir()
        mod.build_workflow_corpus(str(wd))
        mod.build_overlap_eval(str(wd))
        mod.build_overlap_long(str(wd))
    assert _files(tmp_path / "ours") == _files(tmp_path / "jax")
    for stage in ("stage1", "stage2"):
        d = f"data_drift_{stage}"
        for ax in ("x", "y"):
            a = np.load(tmp_path / "ours" / d / f"val_{ax}_fold1.npy",
                        allow_pickle=True).tolist()
            b = np.load(tmp_path / "jax" / d / f"val_{ax}_fold1.npy",
                        allow_pickle=True).tolist()
            if ax == "x":
                a = [p.replace(str(tmp_path / "ours"), "R") for p in a]
                b = [p.replace(str(tmp_path / "jax"), "R") for p in b]
            assert a == b
    ids = (tmp_path / "ours" / "ids_overlap" / "test_ids_fold1.txt")
    assert len(ids.read_text().split()) == drift_bench.N_OVERLAP_PATIENTS


def _jax_init_tree():
    import jax

    from zenker_audio_detection_tpu.models import ast as jast

    cfg = jast.ASTConfig(hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=64,
                         num_labels=527)
    return jast.init_params(jax.random.PRNGKey(3), cfg)


def test_frozen_init_is_jax_init_bitwise():
    """`drift_init.npz` holds JAX's `init_params(PRNGKey(3))` random
    leaves, regenerated here by the JAX package on the CPU: bitwise, so the
    file cannot go stale. Every other leaf of JAX's init is zero or one."""
    tree = _jax_init_tree()
    with np.load(drift_bench.INIT_FILE) as frozen:
        names = set(frozen.files)
        assert len(names) == 8
        for name in names:
            node = tree
            for k in name.split("."):
                node = node[k]
            want = np.asarray(node)
            assert frozen[name].dtype == want.dtype, name
            np.testing.assert_array_equal(frozen[name], want, err_msg=name)

    def leaves(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from leaves(v, prefix + k + ".")
            else:
                yield prefix + k, np.asarray(v)

    for name, v in leaves(tree):
        if name not in names:
            assert np.all((v == 0) | (v == 1)), name


def test_build_pretrained_is_the_port_init(tmp_path):
    """The port's pretrained checkpoint: the JAX module's geometry (h=32,
    L=2, 527 labels) and its weights. The directory the port writes equals
    the one the JAX module writes, config and every tensor."""
    from zenker_audio_detection_tpu.models import convert as jconvert
    from zenker_audio_detection_tpu_torch.models import convert

    d = drift_bench.build_pretrained(str(tmp_path / "ours"))
    dj = jdrift.build_pretrained(str(tmp_path / "jax"))
    params, cfg = convert.load_hf_model_dir(d)
    assert (cfg.hidden_size, cfg.num_hidden_layers, cfg.num_labels) == \
        (32, 2, 527)
    assert sorted(os.listdir(d)) == sorted(os.listdir(dj))
    with open(os.path.join(d, "config.json")) as a, \
            open(os.path.join(dj, "config.json")) as b:
        assert json.load(a) == json.load(b)
    ours = jconvert.read_safetensors(os.path.join(d, "model.safetensors"))
    theirs = jconvert.read_safetensors(os.path.join(dj, "model.safetensors"))
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    want = convert.params_to_numpy(params)
    np.testing.assert_array_equal(
        want["encoder"]["q"]["kernel"],
        np.asarray(_jax_init_tree()["encoder"]["q"]["kernel"]))
