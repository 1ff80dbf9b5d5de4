"""The port's raw-dataset organizers (data/prepare.py) and their CLI
(cli/prepare_dataset.py) against the JAX package's, on the raw tree of
tests/test_prepare_exec_parity.py (specimen suffixes, 1sec/long/other
subfolders, .WAV extensions, csv distractors, a specimen without a long
folder, 16 and 44.1 kHz sources).

Tolerance: none. The organized trees are equal file for file and byte for
byte (both packages decode and re-encode PCM16 with their own WAV codec),
and the printed messages and counts are equal."""

from pathlib import Path

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.cli import prepare_dataset as jprepare_cli
from zenker_audio_detection_tpu.data import prepare as jprepare
from zenker_audio_detection_tpu_torch.cli import prepare_dataset
from zenker_audio_detection_tpu_torch.data import prepare

from test_prepare_exec_parity import _make_raw_tree


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread (the suite runs in several worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    return _make_raw_tree(tmp_path_factory.mktemp("raw") / "raw",
                          np.random.default_rng(20260818))


def tree_bytes(root: Path) -> dict:
    """{relative path: bytes} of every file, and every directory as None
    (an empty patient directory counts)."""
    return {str(p.relative_to(root)): (p.read_bytes() if p.is_file()
                                       else None)
            for p in sorted(root.rglob("*"))}


@pytest.mark.parametrize("fn", ["organize_short_clips",
                                "organize_long_audio"])
def test_organizers_equal_jax(raw, tmp_path, capsys, fn):
    n_ours = getattr(prepare, fn)(str(raw), str(tmp_path / "ours"))
    out_ours = capsys.readouterr().out
    n_jax = getattr(jprepare, fn)(str(raw), str(tmp_path / "jax"))
    assert capsys.readouterr().out == out_ours
    assert n_ours == n_jax > 0
    ours, theirs = tree_bytes(tmp_path / "ours"), tree_bytes(tmp_path / "jax")
    assert ours == theirs
    if fn == "organize_long_audio":
        assert not any(k.startswith("Idle") for k in ours)
        assert not any("Z02" in k for k in ours)
    else:
        assert "Zenker/Z02" in ours


def test_prepare_dataset_cli_equals_jax(raw, tmp_path, capsys):
    for name, mod in (("ours", prepare_dataset), ("jax", jprepare_cli)):
        mod.main(["--mode", "both", "--raw-data-dir", str(raw),
                  "--short-audio-dir", str(tmp_path / name / "short"),
                  "--long-audio-dir", str(tmp_path / name / "long")])
    out = capsys.readouterr().out.splitlines()
    half = len(out) // 2
    assert out[:half] == out[half:]
    assert "Total files processed: 6" in out[:half]
    assert tree_bytes(tmp_path / "ours") == tree_bytes(tmp_path / "jax")


def test_prepare_dataset_cli_reads_env_file(raw, tmp_path, monkeypatch):
    """Without flags the directories come from the project's .env, through
    the port's own data/config.py."""
    for key in ("DATASET_ROOT", "RAW_DATA_DIR", "SHORT_AUDIO_DIR"):
        monkeypatch.delenv(key, raising=False)
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / ".env").write_text(
        f"DATASET_ROOT={tmp_path}\nRAW_DATA_DIR={raw}\n"
        f"SHORT_AUDIO_DIR=${{DATASET_ROOT}}/short_env\n")
    monkeypatch.chdir(proj)
    prepare_dataset.main([])
    got = tree_bytes(tmp_path / "short_env")
    jprepare.organize_short_clips(str(raw), str(tmp_path / "short_jax"))
    assert got and got == tree_bytes(tmp_path / "short_jax")
