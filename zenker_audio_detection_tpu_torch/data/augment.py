"""Waveform augmentations replicating the reference's training pipeline.

The reference composes 7 audiomentations transforms with Compose(p=0.8,
shuffle=True) (src/train_ast_stage1_cross_validation.py:291-311):

  AddGaussianSNR(10..20 dB), Gain(±6 dB), GainTransition(±6 dB over
  1-30% duration), ClippingDistortion(0-30 percentile, p=0.5),
  TimeStretch(0.8-1.2), PitchShift(±4 semitones), TimeMask(1-20%)

Each transform keeps audiomentations' default per-transform p=0.5 unless the
reference overrides it. Exact RNG parity with audiomentations is impossible
and unnecessary (SURVEY §7 hard-part 5) — parameter *distributions* match;
time-stretch/pitch-shift use a librosa-style STFT phase vocoder
(n_fft=2048, hop=512) in numpy.

All transforms are host-side, like the reference's (CPU hot loop #2 in
SURVEY §3.1); they run once at dataset build, mirroring the reference's
eager `datasets.map`.

The port's copy of the JAX package's `data/augment.py`, with the port's own
`ops/resample.resample`. Like the JAX module it dispatches the time stretch
to the native vocoder (`native/vocoder.cpp`, through the port's own binding
`audio/native.py`) when that library is available, and to the numpy
vocoder below otherwise; the numpy one is the native one's numerics oracle
(1e-8).
"""

from __future__ import annotations

import numpy as np

from ..ops import resample as R


# ---------------------------------------------------------------------------
# STFT phase vocoder (librosa-compatible defaults)
# ---------------------------------------------------------------------------

_N_FFT = 2048
_HOP = 512


def _stft(x: np.ndarray) -> np.ndarray:
    window = np.hanning(_N_FFT + 1)[:-1]  # periodic hann
    pad = _N_FFT // 2
    xp = np.pad(x, (pad, pad), mode="reflect") if len(x) >= pad \
        else np.pad(x, (pad, pad))
    n_frames = 1 + (len(xp) - _N_FFT) // _HOP
    idx = (np.arange(n_frames)[:, None] * _HOP + np.arange(_N_FFT)[None, :])
    frames = xp[idx] * window
    return np.fft.rfft(frames, axis=-1).T  # (freq, time)


def _istft(D: np.ndarray, length: int) -> np.ndarray:
    window = np.hanning(_N_FFT + 1)[:-1]
    frames = np.fft.irfft(D.T, n=_N_FFT, axis=-1) * window
    n_frames = frames.shape[0]
    out = np.zeros(_N_FFT + _HOP * (n_frames - 1))
    wsum = np.zeros_like(out)
    for i in range(n_frames):
        out[i * _HOP: i * _HOP + _N_FFT] += frames[i]
        wsum[i * _HOP: i * _HOP + _N_FFT] += window ** 2
    out = out / np.maximum(wsum, 1e-10)
    pad = _N_FFT // 2
    out = out[pad:]
    if len(out) < length:
        out = np.pad(out, (0, length - len(out)))
    return out[:length]


def phase_vocoder_stretch(x: np.ndarray, rate: float) -> np.ndarray:
    """Time-stretch by `rate` (>1 = faster/shorter), librosa-style.

    Dispatches to the native C++ vocoder (same algorithm, OpenMP over STFT
    frames) when the library is available; the numpy body below is the
    fallback and the numerics oracle."""
    if abs(rate - 1.0) < 1e-9:
        return x.copy()
    from ..audio import native

    out = native.phase_vocoder_stretch(x, rate)
    if out is not None:
        return out
    return _numpy_phase_vocoder_stretch(x, rate)


def _numpy_phase_vocoder_stretch(x: np.ndarray, rate: float) -> np.ndarray:
    """Fully vectorized numpy vocoder (the per-step python loop made this
    the training featurization hot spot): the phase accumulator is a prefix
    sum of the per-step wrapped phase deltas, so all output frames are
    built at once."""
    D = _stft(x)
    n_freq, n_frames = D.shape
    time_steps = np.arange(0, n_frames, rate)
    phi_advance = np.linspace(0, np.pi * _HOP, n_freq)

    mag = np.abs(D)
    phase = np.angle(D)
    i0 = time_steps.astype(int)
    i1 = np.minimum(i0 + 1, n_frames - 1)
    frac = time_steps - i0
    m = (1 - frac)[None, :] * mag[:, i0] + frac[None, :] * mag[:, i1]
    dphase = phase[:, i1] - phase[:, i0] - phi_advance[:, None]
    dphase -= 2 * np.pi * np.round(dphase / (2 * np.pi))
    # phase_acc at step t = phase[:,0] + sum_{u<t} (phi_advance + dphase_u)
    steps_total = np.cumsum(phi_advance[:, None] + dphase, axis=1)
    phase_acc = phase[:, :1] + np.concatenate(
        [np.zeros((n_freq, 1)), steps_total[:, :-1]], axis=1)
    out = m * np.exp(1j * phase_acc)
    target_len = int(round(len(x) / rate))
    return _istft(out, target_len)


def pitch_shift(x: np.ndarray, semitones: float, sr: int) -> np.ndarray:
    """librosa.effects.pitch_shift semantics: stretch by 2^(-s/12) then
    resample back to the original duration."""
    rate = 2.0 ** (-semitones / 12.0)
    stretched = phase_vocoder_stretch(x, rate)
    # resample from sr/rate back to sr using a rational approximation.
    # denominator <= 100 keeps the rate error <= 1e-4 (< 0.2 cents of
    # pitch, far inside audiomentations' own tolerance) while making the
    # polyphase kernel ~100x cheaper to design — with 1000 the per-call
    # kernel DESIGN dominated the whole augmentation pipeline (114 ms of
    # the 119 ms streamed-batch cost).
    from fractions import Fraction

    frac = Fraction(rate).limit_denominator(100)
    out = R.resample(stretched.astype(np.float32),
                     int(frac.denominator * sr), int(frac.numerator * sr))
    if len(out) < len(x):
        out = np.pad(out, (0, len(x) - len(out)))
    return np.asarray(out[: len(x)], dtype=np.float64)


# ---------------------------------------------------------------------------
# Individual transforms (audiomentations parameter distributions)
# ---------------------------------------------------------------------------


def add_gaussian_snr(x, rng, min_snr_db=10.0, max_snr_db=20.0):
    snr_db = rng.uniform(min_snr_db, max_snr_db)
    rms = np.sqrt(np.mean(x ** 2)) or 1e-9
    noise_rms = rms / (10.0 ** (snr_db / 20.0))
    return x + rng.standard_normal(len(x)) * noise_rms


def gain(x, rng, min_gain_db=-6.0, max_gain_db=6.0):
    return x * 10.0 ** (rng.uniform(min_gain_db, max_gain_db) / 20.0)


def gain_transition(x, rng, min_gain_db=-6.0, max_gain_db=6.0,
                    min_duration=0.01, max_duration=0.3):
    """Linear-in-dB ramp between TWO random gains over a random span
    (duration as fraction of length): start gain before/into the ramp, end
    gain held afterwards — audiomentations' GainTransition randomizes both
    endpoints ("gradually change volume from one gain to another"), so
    pinning the start at 0 dB would narrow the augmentation distribution.
    (audiomentations is not importable in this environment; semantics
    follow its documented behavior.)"""
    n = len(x)
    dur = int(rng.uniform(min_duration, max_duration) * n)
    dur = max(1, min(dur, n))
    t0 = rng.integers(0, n - dur + 1)
    g0_db = rng.uniform(min_gain_db, max_gain_db)
    g1_db = rng.uniform(min_gain_db, max_gain_db)
    env_db = np.empty(n)
    env_db[:t0] = g0_db
    env_db[t0: t0 + dur] = np.linspace(g0_db, g1_db, dur)
    env_db[t0 + dur:] = g1_db
    return x * 10.0 ** (env_db / 20.0)


def clipping_distortion(x, rng, min_percentile_threshold=0,
                        max_percentile_threshold=30):
    pct = int(rng.integers(min_percentile_threshold,
                           max_percentile_threshold + 1))
    if pct == 0:
        return x.copy()
    lo, hi = np.percentile(x, [pct / 2, 100 - pct / 2])
    return np.clip(x, lo, hi)


def time_stretch(x, rng, min_rate=0.8, max_rate=1.2):
    """leave_length_unchanged=True (audiomentations default): stretched
    output is padded / truncated back to the input length."""
    rate = rng.uniform(min_rate, max_rate)
    y = phase_vocoder_stretch(x, rate)
    if len(y) < len(x):
        y = np.pad(y, (0, len(x) - len(y)))
    return y[: len(x)]


def pitch_shift_transform(x, rng, min_semitones=-4.0, max_semitones=4.0,
                          sr=16000):
    return pitch_shift(x, rng.uniform(min_semitones, max_semitones), sr)


def time_mask(x, rng, min_band_part=0.01, max_band_part=0.2):
    n = len(x)
    band = int(rng.uniform(min_band_part, max_band_part) * n)
    band = max(1, band)
    t0 = rng.integers(0, n - band + 1)
    y = x.copy()
    y[t0: t0 + band] = 0.0
    return y


# ---------------------------------------------------------------------------
# Composition (Compose(p=0.8, shuffle=True) with per-transform p)
# ---------------------------------------------------------------------------

_TRANSFORMS = [
    ("add_gaussian_snr", add_gaussian_snr, 0.5),
    ("gain", gain, 0.5),
    ("gain_transition", gain_transition, 0.5),
    ("clipping_distortion", clipping_distortion, 0.5),
    ("time_stretch", time_stretch, 0.5),
    ("pitch_shift", pitch_shift_transform, 0.5),
    ("time_mask", time_mask, 0.5),
]


def augment_waveform(x: np.ndarray, rng: np.random.Generator,
                     p_compose: float = 0.8) -> np.ndarray:
    """Apply the reference's augmentation chain to one waveform."""
    x = np.asarray(x, dtype=np.float64)
    if rng.random() >= p_compose:
        return x.astype(np.float32)
    order = rng.permutation(len(_TRANSFORMS))
    for i in order:
        _, fn, p = _TRANSFORMS[i]
        if rng.random() < p:
            x = fn(x, rng)
    return x.astype(np.float32)
