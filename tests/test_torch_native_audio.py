"""The port's native audio binding (`audio/native.py`) against the JAX
package's Python oracles, at tests/test_native_audio.py's tolerances:
decode 1e-7, resample 2e-6, vocoder 1e-8.

The port builds the library itself from `native/audioio.cpp` and
`native/vocoder.cpp` into `build/native/` at first use; nothing here runs
`make -C native` or reads `native/libaudioio.so`. Also the dispatch of
`audio/io.load_audio` and `data/augment.phase_vocoder_stretch`, the header
edge cases (placeholder data size, zero sample rate), the short-input edge
of the vocoder, and the report of a failed build."""

import struct

import numpy as np
import pytest

from zenker_audio_detection_tpu.audio import io as jaio
from zenker_audio_detection_tpu.data import augment as JA
from zenker_audio_detection_tpu.ops import resample as JR
from zenker_audio_detection_tpu_torch.audio import io as aio
from zenker_audio_detection_tpu_torch.audio import native
from zenker_audio_detection_tpu_torch.data import augment as A

DECODE_TOL, RESAMPLE_TOL, VOCODER_TOL = 1e-7, 2e-6, 1e-8


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.available(), "the native library did not build"
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.parent.name == "native" and path.parent.parent.name == "build"


def _wav(tmp_path, name, x, sr, dtype="int16"):
    p = str(tmp_path / name)
    aio.write_wav(p, x, sr, dtype=dtype)
    return p


def test_read_mono_int16_stereo_matches_python(tmp_path, rng):
    x = np.clip(rng.standard_normal((2, 12000)) * 0.3, -0.9,
                0.9).astype(np.float32)
    p = _wav(tmp_path, "st.wav", x, 44100)
    mono, sr = native.read_mono(p)
    ref, ref_sr = jaio.read_wav(p)
    assert sr == ref_sr == 44100 and mono.dtype == np.float32
    np.testing.assert_allclose(mono, ref.mean(axis=0), atol=DECODE_TOL)


def test_read_mono_float32_is_exact(tmp_path, rng):
    x = (rng.standard_normal(8000) * 0.5).astype(np.float32)
    mono, sr = native.read_mono(_wav(tmp_path, "f.wav", x, 48000, "float32"))
    assert sr == 48000
    np.testing.assert_array_equal(mono, x)


@pytest.mark.parametrize("orig,new", [(48000, 16000), (44100, 16000),
                                      (16000, 16000), (22050, 16000)])
def test_resample_matches_python(rng, orig, new):
    x = rng.standard_normal(orig).astype(np.float32)
    got = native.resample(x, orig, new)
    want = JR.resample(x, orig, new)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=RESAMPLE_TOL)


@pytest.mark.parametrize("dtype,sr", [("int16", 44100), ("float32", 48000)])
def test_load_audio_matches_python(tmp_path, rng, dtype, sr):
    """The port's load_audio (native) against the JAX package's Python
    path on a stereo file, and against the port's own Python path."""
    x = np.clip(rng.standard_normal((2, sr)) * 0.2, -0.9,
                0.9).astype(np.float32)
    p = _wav(tmp_path, "a.wav", x, sr, dtype)
    got = aio.load_audio(p, 16000)
    wav, got_sr = jaio.read_wav(p)
    want = JR.resample(wav.mean(axis=0), got_sr, 16000)
    assert got.shape == want.shape == (16000,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=RESAMPLE_TOL)
    np.testing.assert_array_equal(got, native.load_audio(p, 16000))


def test_load_audio_without_the_library_takes_the_python_path(
        tmp_path, rng, monkeypatch):
    x = np.clip(rng.standard_normal(22050) * 0.2, -0.9, 0.9).astype(np.float32)
    p = _wav(tmp_path, "b.wav", x, 22050)
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setattr(native, "load_audio", lambda *a: pytest.fail(
        "the native loader was called"))
    wav, sr = jaio.read_wav(p)
    np.testing.assert_array_equal(aio.load_audio(p, 16000),
                                  JR.resample(wav[0], sr, 16000))


def test_placeholder_data_size_decodes_to_eof(tmp_path, rng):
    """A streaming recorder's size-0 data chunk decodes to the end of the
    file, as the Python parser does."""
    x = np.clip(rng.standard_normal(16000) * 0.2, -0.9, 0.9).astype(np.float32)
    raw = bytearray(open(_wav(tmp_path, "a.wav", x, 16000), "rb").read())
    at = raw.find(b"data")
    q = tmp_path / "placeholder.wav"
    q.write_bytes(raw[:at + 4] + struct.pack("<I", 0) + raw[at + 8:])
    got = native.load_audio(str(q), 16000)
    wav, _ = jaio.read_wav(str(q))
    assert got is not None and len(got) == 16000
    np.testing.assert_allclose(got, wav.mean(axis=0), atol=RESAMPLE_TOL)


def test_zero_sample_rate_header_is_refused(tmp_path, rng):
    """sample_rate = 0 in the header: the native path returns None (no
    division by zero in the host process), the resample guards refuse
    invalid rates, and load_audio falls back to the Python path, which
    raises its typed error."""
    x = np.clip(rng.standard_normal(4000) * 0.3, -0.9, 0.9).astype(np.float32)
    raw = bytearray(open(_wav(tmp_path, "ok.wav", x, 16000), "rb").read())
    fmt_at = raw.find(b"fmt ") + 8
    raw[fmt_at + 4: fmt_at + 8] = struct.pack("<I", 0)
    bad = tmp_path / "zero_sr.wav"
    bad.write_bytes(bytes(raw))
    assert native.read_mono(str(bad)) is None
    assert native.load_audio(str(bad)) is None
    assert native.resample(x, 0, 16000) is None
    assert native.resample(x, 16000, -1) is None
    with pytest.raises(ValueError):
        jaio.load_audio(str(bad))
    with pytest.raises(ValueError):
        aio.load_audio(str(bad))


def test_read_mono_keeps_only_the_decoded_frames(tmp_path, rng):
    """The v2 read reports the frames it decoded; an oversized buffer's
    tail stays untouched and read_mono returns exactly the decoded span."""
    import ctypes

    x = np.clip(rng.standard_normal(5000) * 0.3, -0.9, 0.9).astype(np.float32)
    p = _wav(tmp_path, "a.wav", x, 16000)
    lib = native.load_library()
    out = np.full(5000 + 64, np.nan, dtype=np.float32)
    sr, frames = ctypes.c_int(), ctypes.c_longlong()
    rc = lib.audioio_read_mono_v2(
        p.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(out), ctypes.byref(sr), ctypes.byref(frames))
    assert rc == 0 and sr.value == 16000 and frames.value == 5000
    assert np.isnan(out[5000:]).all()
    got, got_sr = native.read_mono(p)
    assert len(got) == 5000 and got_sr == 16000


@pytest.mark.parametrize("rate", [0.8, 0.93, 1.07, 1.2, 2 ** (4 / 12),
                                  2 ** (-4 / 12)])
def test_vocoder_matches_the_numpy_oracle(rng, rate):
    x = rng.standard_normal(16000)
    got = native.phase_vocoder_stretch(x, rate)
    want = JA._numpy_phase_vocoder_stretch(x, rate)
    assert got is not None and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=VOCODER_TOL)
    np.testing.assert_array_equal(A.phase_vocoder_stretch(x, rate), got)


def test_vocoder_short_input_edge(rng):
    """At or below n_fft // 2 = 1024 samples the native vocoder declines
    (numpy's multi-reflection pad) and the dispatcher takes the numpy
    vocoder; 1025 is the first length the native one handles."""
    for n in (512, 1024):
        x = rng.standard_normal(n)
        assert native.phase_vocoder_stretch(x, 1.1) is None
        np.testing.assert_array_equal(A.phase_vocoder_stretch(x, 1.1),
                                      JA._numpy_phase_vocoder_stretch(x, 1.1))
    x = rng.standard_normal(1025)
    got = native.phase_vocoder_stretch(x, 1.1)
    assert got is not None
    np.testing.assert_allclose(got, JA._numpy_phase_vocoder_stretch(x, 1.1),
                               atol=VOCODER_TOL)


def test_a_failed_build_is_reported_once(monkeypatch, capsys):
    """No compiler: available() says why once on stderr and is False, and
    every function returns None, so callers take the Python path."""
    monkeypatch.setattr(native, "_state", {})
    monkeypatch.setattr(native, "CXX", "no-such-compiler-zenker")
    assert native.available() is False
    assert native.available() is False
    err = capsys.readouterr().err
    assert err.count("native audio library unavailable") == 1
    assert "no-such-compiler-zenker" in err
    assert native.phase_vocoder_stretch(np.zeros(4096), 1.1) is None
    assert native.resample(np.zeros(100, np.float32), 48000, 16000) is None
