"""The port's log-mel front end against the JAX package's and against the
frozen HF goldens (tests/golden/fbank_golden.npz)."""

import os

import numpy as np
import pytest
import torch

from zenker_audio_detection_tpu.ops import fbank as JF
from zenker_audio_detection_tpu_torch.ops import fbank as F

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def fbank_golden():
    return np.load(os.path.join(GOLDEN, "fbank_golden.npz"))


@pytest.mark.parametrize("kind", ["float32", "int16"])
def test_logmel_frames_matches_jax(kind):
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    x = rng.standard_normal(16000 * 2 + 123).astype(np.float32) * 0.1
    if kind == "int16":
        x = (x * 32768).clip(-32768, 32767).astype(np.int16)
    n = F.num_frames(len(x))
    want = np.asarray(JF.logmel_frames(jnp.asarray(x), n))
    got = F.logmel_frames(torch.from_numpy(x), n).numpy()
    assert got.shape == want.shape == (n, F.NUM_MEL_BINS)
    # both are f32 matmuls of the same values, summed in different orders;
    # the log magnifies that in the low-power bins (4.9e-4 seen here), so
    # the bound is the golden test's 1e-3 for bins near the floor
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("clip", ["one_sec", "half_sec", "tone"])
def test_logmel_frames_matches_golden(fbank_golden, clip):
    x = fbank_golden[f"{clip}_in"]
    want = fbank_golden[f"{clip}_raw"]
    got = F.logmel_frames(torch.from_numpy(x), F.num_frames(len(x))).numpy()
    assert got.shape == want.shape
    # tests/test_golden.py's tolerances: the tone sits at the Kaldi floor in
    # most bins, where f32 rounding is magnified by the log
    np.testing.assert_allclose(got, want, atol=1e-3 if clip == "tone" else 5e-4)


@pytest.mark.parametrize("clip", ["one_sec", "half_sec", "tone"])
def test_logmel_frames_rfft_matches_golden(fbank_golden, clip):
    """The `torch.fft.rfft` branch (use_matmul_dft=False) at the golden
    tolerances of tests/test_golden.py:53-64."""
    x = fbank_golden[f"{clip}_in"]
    want = fbank_golden[f"{clip}_raw"]
    got = F.logmel_frames(torch.from_numpy(x), F.num_frames(len(x)),
                          use_matmul_dft=False).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3 if clip == "tone" else 5e-4)


@pytest.mark.parametrize("kind", ["float32", "int16"])
def test_logmel_frames_rfft_matches_jax(kind):
    """Both packages' rfft branch on the same seeded waveform, at the bound
    of test_logmel_frames_matches_jax (f32 sums in other orders, magnified
    by the log in low-power bins)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    x = rng.standard_normal(16000 + 321).astype(np.float32) * 0.1
    if kind == "int16":
        x = (x * 32768).clip(-32768, 32767).astype(np.int16)
    n = F.num_frames(len(x))
    want = np.asarray(JF.logmel_frames(jnp.asarray(x), n,
                                       use_matmul_dft=False))
    got = F.logmel_frames(torch.from_numpy(x), n, use_matmul_dft=False)
    assert got.shape == want.shape == (n, F.NUM_MEL_BINS)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


@pytest.mark.parametrize("n", [1, 2, 98, 301])
def test_frame_indices_match_jax_and_the_hop_slices(n):
    """`frame_indices` is the JAX package's exactly, and gathering with it
    gives the frames of the hop-slice framing bit for bit."""
    got = F.frame_indices(n)
    want = JF.frame_indices(n)
    assert got.dtype == np.int32 and got.shape == (n, F.FRAME_LENGTH)
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(n)
    wave = torch.from_numpy(rng.standard_normal(
        (2, n * F.HOP_LENGTH + F.FRAME_LENGTH)).astype(np.float32))
    gathered = wave[..., torch.from_numpy(got).long()]
    torch.testing.assert_close(gathered, F._frames_by_hop_slices(wave, n),
                               atol=0, rtol=0)


def test_rfft_normalized_features_match_golden(fbank_golden):
    x = torch.from_numpy(fbank_golden["one_sec_in"])
    want = fbank_golden["one_sec_normalized_full"]
    cfg = F.FbankConfig(mean=float(fbank_golden["norm_mean"]),
                        std=float(fbank_golden["norm_std"]))
    got = F.ast_features(x[None], cfg, use_matmul_dft=False)[0].numpy()
    assert got.shape == want.shape == (F.MAX_FRAMES, F.NUM_MEL_BINS)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_normalized_features_match_golden(fbank_golden):
    x = torch.from_numpy(fbank_golden["one_sec_in"])
    want = fbank_golden["one_sec_normalized_full"]
    mean = float(fbank_golden["norm_mean"])
    std = float(fbank_golden["norm_std"])
    got = F.ast_features(x[None], F.FbankConfig(mean=mean, std=std))[0].numpy()
    assert got.shape == want.shape == (F.MAX_FRAMES, F.NUM_MEL_BINS)
    np.testing.assert_allclose(got, want, atol=2e-4)
    # pad rows are normalized zeros (HF pad-then-normalize)
    np.testing.assert_allclose(got[200:], (0.0 - mean) / (2.0 * std), atol=1e-6)


def test_window_features_from_frames_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    x = rng.standard_normal(16000 * 3).astype(np.float32) * 0.1
    n = F.num_frames(len(x))
    fpw, hop = F.window_frame_geometry(1.0, 0.5)
    starts = np.arange(0, n - fpw + 1, hop)
    cfg = F.FbankConfig(max_length=128, mean=-1.0, std=3.0)
    jcfg = JF.FbankConfig(max_length=128, mean=-1.0, std=3.0)
    frames = F.logmel_frames(torch.from_numpy(x), n)
    got = F.window_features_from_frames(frames, starts, fpw, cfg).numpy()
    want = np.asarray(JF.window_features_from_frames(
        JF.logmel_frames(jnp.asarray(x), n), jnp.asarray(starts), fpw, jcfg))
    assert got.shape == want.shape == (len(starts), 128, F.NUM_MEL_BINS)
    np.testing.assert_allclose(got, want, atol=1e-3)
    # frame reuse is exact: each window equals featurizing its own samples
    per_window = F.ast_features(
        torch.stack([torch.from_numpy(x[s * 160: s * 160 + 16000])
                     for s in starts]), cfg).numpy()
    np.testing.assert_allclose(got, per_window, atol=1e-4)


@pytest.mark.parametrize("starts", [[0, 3], [-1], [2]])
def test_window_features_from_frames_rejects_out_of_range(starts):
    frames = torch.zeros(100, F.NUM_MEL_BINS)
    with pytest.raises(ValueError, match="out of range"):
        F.window_features_from_frames(frames, np.asarray(starts), 99)


def test_logmel_frames_rejects_zero_frames():
    with pytest.raises(ValueError, match="too short"):
        F.logmel_frames(torch.zeros(100), 0)
