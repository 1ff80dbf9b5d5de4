"""The port's augmentation chain (`data/augment.py`) against the JAX
package's, transform by transform and composed, on the same inputs and the
same `np.random.default_rng` seeds, at atol 1e-6.

Both packages dispatch the time stretch to the native vocoder when their
library is available, so the oracle comparisons pin both sides to the numpy
vocoder (`numpy_vocoder`), and one case runs both on the native one
(`native_vocoder`: the JAX binding loads the library the port builds from
the same sources). Also the JAX tests' behavioural checks
(tests/test_augment.py) on the port."""

import numpy as np
import pytest

from zenker_audio_detection_tpu.audio import native as jax_native
from zenker_audio_detection_tpu.data import augment as JA
from zenker_audio_detection_tpu_torch.audio import native as port_native
from zenker_audio_detection_tpu_torch.data import augment as A

ATOL = 1e-6
TRANSFORMS = [name for name, _, _ in JA._TRANSFORMS]


@pytest.fixture
def numpy_vocoder(monkeypatch):
    for native in (jax_native, port_native):
        monkeypatch.setattr(native, "phase_vocoder_stretch",
                            lambda x, rate: None)


@pytest.fixture
def native_vocoder(monkeypatch):
    """Both packages on the native vocoder: the JAX binding is pointed at
    the library the port built (never `make -C native` from here)."""
    assert port_native.available()
    monkeypatch.setenv("ZENKER_AUDIOIO_LIB", str(port_native.library_path()))
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_TRIED", False)
    assert jax_native.available()


def _signal(seed: int, n: int = 16000) -> np.ndarray:
    rng = np.random.default_rng(1000 + seed)
    t = np.arange(n) / 16000
    return (np.sin(2 * np.pi * 440 * t)
            + 0.1 * rng.standard_normal(n)).astype(np.float64)


def test_the_port_runs_the_same_transforms():
    assert [(n, p) for n, _, p in A._TRANSFORMS] == \
        [(n, p) for n, _, p in JA._TRANSFORMS]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", TRANSFORMS)
def test_transform_matches_jax(numpy_vocoder, name, seed):
    fn = dict((n, f) for n, f, _ in A._TRANSFORMS)[name]
    jfn = dict((n, f) for n, f, _ in JA._TRANSFORMS)[name]
    x = _signal(seed)
    got = fn(x, np.random.default_rng(seed))
    want = jfn(x, np.random.default_rng(seed))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("rate", [0.8, 0.93, 1.0, 1.25])
def test_vocoder_matches_jax_numpy_path(numpy_vocoder, rate):
    x = _signal(3)
    np.testing.assert_allclose(A.phase_vocoder_stretch(x, rate),
                               JA._numpy_phase_vocoder_stretch(x, rate)
                               if rate != 1.0 else x, atol=ATOL)


@pytest.mark.parametrize("semitones", [-4.0, -1.5, 2.5, 4.0])
def test_pitch_shift_matches_jax(numpy_vocoder, semitones):
    x = _signal(4)
    np.testing.assert_allclose(A.pitch_shift(x, semitones, 16000),
                               JA.pitch_shift(x, semitones, 16000),
                               atol=ATOL)


@pytest.mark.parametrize("seed", range(8))
def test_augment_waveform_matches_jax(numpy_vocoder, seed):
    n = 16000 if seed % 2 else 12345  # odd lengths too
    x = _signal(seed, n).astype(np.float32)
    got = A.augment_waveform(x, np.random.default_rng(seed))
    want = JA.augment_waveform(x, np.random.default_rng(seed))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("seed", [1, 2])
def test_augment_waveform_matches_jax_both_native(native_vocoder, seed):
    x = _signal(seed).astype(np.float32)
    assert port_native.phase_vocoder_stretch(x, 1.1) is not None
    got = A.augment_waveform(x, np.random.default_rng(seed))
    want = JA.augment_waveform(x, np.random.default_rng(seed))
    np.testing.assert_allclose(got, want, atol=ATOL)
    stretched = A.phase_vocoder_stretch(x.astype(np.float64), 0.93)
    np.testing.assert_array_equal(
        stretched, jax_native.phase_vocoder_stretch(x.astype(np.float64),
                                                    0.93))


def test_augment_preserves_length_and_dtype():
    rng = np.random.default_rng(0)
    tone = _signal(0)
    for _ in range(10):
        y = A.augment_waveform(tone, rng)
        assert y.shape == tone.shape and y.dtype == np.float32


def test_augment_deterministic_given_rng():
    tone = _signal(1)
    np.testing.assert_array_equal(
        A.augment_waveform(tone, np.random.default_rng(5)),
        A.augment_waveform(tone, np.random.default_rng(5)))


def test_compose_probability_zero_is_identity():
    tone = _signal(2)
    y = A.augment_waveform(tone, np.random.default_rng(0), p_compose=0.0)
    np.testing.assert_array_equal(y, tone.astype(np.float32))


def test_augment_waveform_always_finite_and_shape_preserving():
    """The JAX test's property: no non-finite sample and no change of
    length across amplitudes 1e-4 .. 0.95, odd lengths and zero input."""
    rng = np.random.default_rng(0)
    for seed in range(10):
        n = int(rng.integers(1600, 32000))
        x = (rng.standard_normal(n)
             * rng.choice([1e-4, 0.01, 0.3, 0.95])).astype(np.float32)
        out = A.augment_waveform(x, np.random.default_rng(seed))
        assert out.shape == x.shape and np.isfinite(out).all()
    for n in (1600, 1601, 15999):
        out = A.augment_waveform(np.zeros(n, np.float32),
                                 np.random.default_rng(1))
        assert out.shape == (n,) and np.isfinite(out).all()
