"""The port's host-side copies (WAV codec, resampler, discovery) against
the JAX package's modules and the resample goldens."""

import os

import numpy as np
import pytest

from zenker_audio_detection_tpu.audio import io as jaio
from zenker_audio_detection_tpu.infer import discovery as jdiscovery
from zenker_audio_detection_tpu_torch.audio import io as aio
from zenker_audio_detection_tpu_torch.infer import discovery
from zenker_audio_detection_tpu_torch.ops import resample as R

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("case", ["noise_48k_to_16k", "noise_44k1_to_16k",
                                  "tone_48k_to_16k"])
def test_resample_matches_golden(case):
    g = np.load(os.path.join(GOLDEN, "resample_golden.npz"))
    orig, new = g[f"{case}_rates"]
    got = R.resample(g[f"{case}_in"], int(orig), int(new))
    assert got.shape == g[f"{case}_out"].shape
    # tests/test_golden.py's bound for the host resampler
    np.testing.assert_allclose(got, g[f"{case}_out"], atol=1e-6)


@pytest.mark.parametrize("sr,channels,dtype", [(16000, 1, "int16"),
                                               (48000, 2, "int16"),
                                               (44100, 1, "float32")])
def test_loaders_match_jax(tmp_path, sr, channels, dtype):
    rng = np.random.default_rng(sr + channels)
    x = np.clip(rng.standard_normal((channels, sr // 2)) * 0.2, -0.9, 0.9)
    path = str(tmp_path / "x.wav")
    aio.write_wav(path, x.astype(np.float32), sr, dtype=dtype)
    with open(path, "rb") as f:
        written = f.read()
    jpath = str(tmp_path / "j.wav")
    jaio.write_wav(jpath, x.astype(np.float32), sr, dtype=dtype)
    with open(jpath, "rb") as f:
        assert f.read() == written
    for port_fn, jax_fn in ((aio.load_audio_compact, jaio.load_audio_compact),
                            (aio.load_audio, jaio.load_audio)):
        got, want = port_fn(path), jax_fn(path)
        assert got.dtype == want.dtype
        # the JAX loader may take the native C++ path: 1e-6 (its parity
        # bound with the Python path, audio/native.py)
        np.testing.assert_allclose(got, want, atol=1e-6)
    wav, got_sr = aio.read_wav(path)
    assert got_sr == sr and wav.shape == (channels, sr // 2)


def test_discovery_matches_jax(tmp_path):
    root = tmp_path / "data"
    for patient, lengths in (("P001", (1.0, 3.0, 2.0)), ("P002", (1.0,))):
        d = root / "Zenker" / patient
        d.mkdir(parents=True)
        for k, seconds in enumerate(lengths):
            aio.write_wav(str(d / f"rec_{k}.wav"),
                          np.zeros(int(16000 * seconds), np.float32), 16000)
    got = discovery.discover_two_files(str(root), "P001")
    assert got == jdiscovery.discover_two_files(str(root), "P001")
    assert [os.path.basename(p) for p in got] == ["rec_1.wav", "rec_2.wav"]
    for fn in (discovery.discover_two_files, jdiscovery.discover_two_files):
        with pytest.raises(ValueError, match="exactly 2"):
            fn(str(root), "P002")

