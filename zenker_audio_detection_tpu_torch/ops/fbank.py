"""Kaldi-compatible log-mel filterbank features for AST, in PyTorch.

Port of the JAX package's `ops/fbank.py`, with the same numerics as
`transformers.ASTFeatureExtractor`:

  frame (400 samples / 160 hop, snip-edges) -> per-frame DC removal ->
  preemphasis 0.97 -> symmetric Hann window -> 512-pt DFT -> |.|^2 ->
  128 Kaldi-mel triangles (20 Hz .. Nyquist) -> max(floor) -> ln ->
  pad/truncate to 1024 frames -> (x - mean) / (2 * std)

The DFT of a 400-sample frame zero-padded to 512 is a linear map, so the
front end is three f32 matmuls (power = (f C)^2 + (f S)^2, mel = power M);
`use_matmul_dft=False` takes the power from `torch.fft.rfft` instead, as
the JAX package's option does. They run in true f32 (`utils.precision.full_f32`): with TF32 the log turns
the lost mantissa bits into O(0.5) errors in low-power mel bins.

For long recordings, sliding windows on the 160-sample frame grid share
frames: `logmel_frames` computes the file-level frame matrix once and
`window_features_from_frames` gathers each window's block of frames.

A model module names its front end (`FrontEnd`, its `FRONT_END`): the
default is the extractor's above (the AST's); another window type
("povey": the symmetric Hann window to the power 0.85) and a factor on
the [-1, 1] audio give Kaldi's other defaults.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as nnf

from ..utils.precision import full_f32

SAMPLING_RATE = 16000
FRAME_LENGTH = 400  # 25 ms
HOP_LENGTH = 160  # 10 ms
FFT_LENGTH = 512  # next pow2 of 400
NUM_FREQ_BINS = FFT_LENGTH // 2 + 1  # 257
NUM_MEL_BINS = 128
MAX_FRAMES = 1024
PREEMPHASIS = 0.97
MEL_FLOOR = 1.192092955078125e-07  # float32 eps, the Kaldi/HF log floor
MEL_FMIN = 20.0

# AudioSet defaults (ASTFeatureExtractor); deployments override these with
# per-fold dataset statistics.
AUDIOSET_MEAN = -4.2677393
AUDIOSET_STD = 4.5689974
DATASET_FALLBACK_MEAN = -1.1509622
DATASET_FALLBACK_STD = 3.5340312


def num_frames(num_samples: int) -> int:
    """Snip-edges frame count: 1 + floor((N - 400) / 160); 0 if too short."""
    if num_samples < FRAME_LENGTH:
        return 0
    return 1 + (num_samples - FRAME_LENGTH) // HOP_LENGTH


def hertz_to_mel_kaldi(freq):
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def mel_filter_bank_kaldi(
    num_frequency_bins: int = NUM_FREQ_BINS,
    num_mel_filters: int = NUM_MEL_BINS,
    min_frequency: float = MEL_FMIN,
    max_frequency: float = SAMPLING_RATE / 2,
    sampling_rate: int = SAMPLING_RATE,
) -> np.ndarray:
    """Kaldi-scale triangular mel filters, triangularized in mel space
    (`transformers.audio_utils.mel_filter_bank(..., norm=None,
    mel_scale="kaldi", triangularize_in_mel_space=True)`). Returns
    (num_freq, num_mel) float64."""
    mel_min = hertz_to_mel_kaldi(min_frequency)
    mel_max = hertz_to_mel_kaldi(max_frequency)
    filter_mels = np.linspace(mel_min, mel_max, num_mel_filters + 2)

    fft_bin_width = sampling_rate / ((num_frequency_bins - 1) * 2)
    fft_mels = hertz_to_mel_kaldi(fft_bin_width * np.arange(num_frequency_bins))

    filter_diff = np.diff(filter_mels)
    slopes = filter_mels[None, :] - fft_mels[:, None]
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    fbank = np.maximum(0.0, np.minimum(down_slopes, up_slopes))
    return fbank.astype(np.float64)


def hann_window_symmetric(length: int = FRAME_LENGTH) -> np.ndarray:
    """Symmetric (periodic=False) Hann window, Kaldi's "hanning"."""
    n = np.arange(length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / (length - 1))


WINDOW_TYPES = ("hanning", "povey")


def frame_window(window_type: str, length: int = FRAME_LENGTH) -> np.ndarray:
    """Kaldi's window of `window_type`: "hanning" the symmetric Hann
    window, "povey" that window to the power 0.85."""
    if window_type not in WINDOW_TYPES:
        raise ValueError(f"window_type must be one of {WINDOW_TYPES}, got "
                         f"{window_type!r}")
    hann = hann_window_symmetric(length)
    return hann if window_type == "hanning" else hann ** 0.85


@dataclasses.dataclass(frozen=True)
class FrontEnd:
    """How a model's log-mel frames are computed: Kaldi's window type and
    the factor on [-1, 1] audio before framing (int16 PCM is x / 32768)."""

    window_type: str = "hanning"
    waveform_scale: float = 1.0


@functools.lru_cache(maxsize=4)
def _dft_matrices(frame_length: int = FRAME_LENGTH, fft_length: int = FFT_LENGTH):
    """Real/imag DFT matrices (frame_length, num_bins) for the matmul DFT.

    X[k] = sum_n f[n] * exp(-2*pi*i*k*n / fft_length); the zero-padding of the
    frame to fft_length contributes nothing, so only the first frame_length
    rows are needed."""
    n = np.arange(frame_length, dtype=np.float64)[:, None]
    k = np.arange(fft_length // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / fft_length
    cos_m = np.cos(ang)
    sin_m = -np.sin(ang)
    return cos_m.astype(np.float32), sin_m.astype(np.float32)


@functools.lru_cache(maxsize=4)
def _host_constants(window_type: str = "hanning"):
    window = frame_window(window_type).astype(np.float32)
    mel = mel_filter_bank_kaldi().astype(np.float32)
    return window, mel


@functools.lru_cache(maxsize=8)
def _device_constants(device: torch.device, window_type: str = "hanning"):
    """(window, mel bank, DFT cos, DFT sin) as f32 tensors on `device`,
    copied there once: a host-to-device copy per call would wait for the
    device's queued work."""
    window, mel = _host_constants(window_type)
    cos_m, sin_m = _dft_matrices()
    return tuple(torch.from_numpy(a).to(device)
                 for a in (window, mel, cos_m, sin_m))


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    """Feature extraction config mirroring ASTFeatureExtractor fields."""

    sampling_rate: int = SAMPLING_RATE
    num_mel_bins: int = NUM_MEL_BINS
    max_length: int = MAX_FRAMES
    do_normalize: bool = True
    mean: float = AUDIOSET_MEAN
    std: float = AUDIOSET_STD

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["feature_extractor_type"] = "ASTFeatureExtractor"
        return d


def frame_indices(n_frames: int) -> np.ndarray:
    """(n_frames, FRAME_LENGTH) int32 sample-index matrix of snip-edges
    framing: row i holds i * HOP_LENGTH .. i * HOP_LENGTH + FRAME_LENGTH - 1."""
    starts = np.arange(n_frames, dtype=np.int32)[:, None] * HOP_LENGTH
    offs = np.arange(FRAME_LENGTH, dtype=np.int32)[None, :]
    return starts + offs


def _frames_by_hop_slices(waveform: torch.Tensor, n_frames: int) -> torch.Tensor:
    """Snip-edges framing as reshape + 3 contiguous slices + concat.

    Sample-identical to `waveform[..., frame_indices(n_frames)]` without the
    (n_frames, 400) gather. With FRAME_LENGTH = 400 = 2*HOP + 80, frame i is
    hop[i] ++ hop[i+1] ++ hop[i+2][:80]; the zero-pad up to (n_frames+2) hops
    only touches samples beyond what emitted frames read."""
    hop2 = FRAME_LENGTH - 2 * HOP_LENGTH
    need = (n_frames + 2) * HOP_LENGTH
    cur = waveform.shape[-1]
    if cur < need:
        waveform = nnf.pad(waveform, (0, need - cur))
    elif cur > need:
        waveform = waveform[..., :need]
    hops = waveform.reshape(waveform.shape[:-1] + (n_frames + 2, HOP_LENGTH))
    return torch.cat(
        [hops[..., :-2, :], hops[..., 1:-1, :], hops[..., 2:, :hop2]], dim=-1)


def _preprocess_frames(frames: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Per-frame DC removal, preemphasis and windowing (Kaldi order)."""
    frames = frames - frames.mean(dim=-1, keepdim=True)
    head = frames[..., :1] * (1.0 - PREEMPHASIS)
    tail = frames[..., 1:] - PREEMPHASIS * frames[..., :-1]
    return torch.cat([head, tail], dim=-1) * window


def logmel_frames(waveform: torch.Tensor, n_frames: int, *,
                  use_matmul_dft: bool = True,
                  front_end: FrontEnd = FrontEnd()) -> torch.Tensor:
    """Log-mel features for all frames of `waveform`.

    Args:
      waveform: (..., num_samples) float32 or int16 audio at 16 kHz; int16
        is scaled by 1/32768 on the tensor's device.
      n_frames: frame count (use `num_frames(num_samples)`).
      use_matmul_dft: the DFT as two f32 matmuls (the default, the engine's
        path) instead of `torch.fft.rfft`; both run on the tensor's device.
      front_end: the model's window type and audio scale; int16 PCM is
        scaled by `waveform_scale` / 32768 in one product (none where that
        is 1, as BEATs takes the PCM values themselves).

    Returns:
      (..., n_frames, NUM_MEL_BINS) float32 log-mel features (unnormalized,
      unpadded), on the waveform's device.
    """
    if n_frames <= 0:
        raise ValueError(
            f"waveform too short for even one {FRAME_LENGTH}-sample frame "
            f"(got n_frames={n_frames}); minimum is {FRAME_LENGTH} samples")
    window, mel, cos_m, sin_m = _device_constants(waveform.device,
                                                  front_end.window_type)
    scale = front_end.waveform_scale
    if waveform.dtype == torch.int16:
        scale = scale / 32768.0
        waveform = waveform.float()
    if scale != 1.0:
        waveform = waveform * scale
    frames = _preprocess_frames(_frames_by_hop_slices(waveform, n_frames),
                                window)
    with full_f32():
        if use_matmul_dft:
            re = torch.matmul(frames, cos_m)
            im = torch.matmul(frames, sin_m)
            power = re * re + im * im
        else:
            power = torch.fft.rfft(frames, n=FFT_LENGTH, dim=-1).abs() ** 2
        mel_energies = torch.matmul(power, mel)
    return torch.log(torch.clamp_min(mel_energies, MEL_FLOOR))


def pad_and_normalize(feats: torch.Tensor,
                      config: FbankConfig = FbankConfig()) -> torch.Tensor:
    """Pad/truncate the frame axis to max_length, then (x - mean) / (2 * std).

    The HF order: padding zeros are *also* normalized, so padded rows
    become (0 - mean) / (2 std)."""
    t = feats.shape[-2]
    if t < config.max_length:
        feats = nnf.pad(feats, (0, 0, 0, config.max_length - t))
    elif t > config.max_length:
        feats = feats[..., :config.max_length, :]
    if config.do_normalize:
        feats = (feats - config.mean) / (config.std * 2.0)
    return feats


def ast_features(waveforms: torch.Tensor,
                 config: FbankConfig = FbankConfig(), *,
                 use_matmul_dft: bool = True) -> torch.Tensor:
    """Full AST feature path: (B, num_samples) -> (B, max_length, 128).

    A sub-frame waveform (< 400 samples) yields all-pad features, as HF
    does. `use_matmul_dft` as in `logmel_frames`."""
    n = num_frames(waveforms.shape[-1])
    if n <= 0:
        feats = torch.zeros(waveforms.shape[:-1] + (0, NUM_MEL_BINS),
                            dtype=torch.float32, device=waveforms.device)
        return pad_and_normalize(feats, config)
    return pad_and_normalize(
        logmel_frames(waveforms, n, use_matmul_dft=use_matmul_dft), config)


def window_frame_geometry(window_sec: float, hop_sec: float,
                          sr: int = SAMPLING_RATE):
    """Frames-per-window and frame-hop between successive windows; valid
    when the window hop in samples is a multiple of HOP_LENGTH."""
    win = int(window_sec * sr)
    hop = int(hop_sec * sr)
    if hop % HOP_LENGTH != 0:
        raise ValueError(
            f"window hop {hop} samples is not a multiple of the frame hop "
            f"{HOP_LENGTH}; frame reuse is not exact")
    return num_frames(win), hop // HOP_LENGTH


def window_features_from_frames(
    file_frames: torch.Tensor,
    window_starts,
    frames_per_window: int,
    config: FbankConfig = FbankConfig(),
) -> torch.Tensor:
    """Gather per-window AST features from file-level log-mel frames.

    Args:
      file_frames: (n_file_frames, 128) from `logmel_frames` on the file.
      window_starts: (W,) frame index of each window's first frame.
      frames_per_window: frames per window (98 for 1 s windows).

    Returns:
      (W, max_length, 128) normalized features, identical to featurizing
      each window's samples independently.
    """
    # An index past the frames is a device assert on CUDA (and JAX's gather
    # would clamp it): check the range before indexing.
    starts = torch.as_tensor(window_starts, dtype=torch.int64)
    n_file = int(file_frames.shape[0])
    if starts.numel() and (int(starts.min()) < 0
                           or int(starts.max()) + frames_per_window > n_file):
        raise ValueError(
            f"window_starts out of range: starts in "
            f"[{int(starts.min())}, {int(starts.max())}] with "
            f"frames_per_window={frames_per_window} exceed the "
            f"{n_file} file frames")
    starts = starts.to(file_frames.device)
    offs = torch.arange(frames_per_window, device=file_frames.device)
    feats = file_frames[starts[:, None] + offs[None, :]]
    return pad_and_normalize(feats, config)
