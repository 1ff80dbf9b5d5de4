"""Kaldi log-mel features as `ASTFeatureExtractor` computes them, float32.

Per 1 s window of 16 kHz audio: 25 ms frames every 10 ms (snip edges),
each frame's mean removed, pre-emphasis 0.97, a symmetric Hann window, the
power spectrum of a 512-point FFT, 128 triangular filters on Kaldi's mel
scale from 20 Hz to Nyquist, the log above float32's epsilon; then the
frames are padded with zeros to the model's length and normalised as
(x - mean) / (2 std), pad rows included.
"""

from __future__ import annotations

import numpy as np
import torch

SAMPLE_RATE = 16000
FRAME = 400
HOP = 160
FFT = 512
MEL_BINS = 128
LOW_HZ = 20.0
PREEMPH = 0.97
FLOOR = float(np.finfo(np.float32).eps)


def mel_bank() -> np.ndarray:
    """(FFT / 2 + 1, MEL_BINS) triangles, even in Kaldi's mel scale."""
    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    edges = np.linspace(mel(LOW_HZ), mel(SAMPLE_RATE / 2), MEL_BINS + 2)
    bins = mel(np.arange(FFT // 2 + 1) * SAMPLE_RATE / FFT)[:, None]
    left, center, right = edges[None, :-2], edges[None, 1:-1], edges[None, 2:]
    up = (bins - left) / (center - left)
    down = (right - bins) / (right - center)
    return np.maximum(0.0, np.minimum(up, down))


def logmel(audio: torch.Tensor) -> torch.Tensor:
    """(..., samples) float32 audio in [-1, 1] -> (..., frames, MEL_BINS)."""
    frames = audio.unfold(-1, FRAME, HOP).double()
    frames = frames - frames.mean(-1, keepdim=True)
    frames = torch.cat([frames[..., :1] * (1 - PREEMPH),
                        frames[..., 1:] - PREEMPH * frames[..., :-1]], -1)
    n = torch.arange(FRAME, dtype=torch.float64, device=audio.device)
    frames = (frames * (0.5 - 0.5 * torch.cos(2 * np.pi * n / (FRAME - 1))))
    power = torch.fft.rfft(frames.float(), n=FFT).abs() ** 2
    bank = torch.as_tensor(mel_bank(), dtype=torch.float32,
                           device=audio.device)
    return torch.log(torch.clamp_min(power @ bank, FLOOR))


def window_features(pcm: np.ndarray, starts: np.ndarray, window: int,
                    max_length: int, mean: float, std: float,
                    device) -> torch.Tensor:
    """(len(starts), max_length, MEL_BINS) normalised features of the int16
    windows pcm[s : s + window], each featurised from its own samples."""
    idx = starts[:, None] + np.arange(window)[None, :]
    audio = torch.as_tensor(pcm[idx], device=device).float() / 32768.0
    feats = logmel(audio)
    pad = max_length - feats.shape[-2]
    feats = torch.nn.functional.pad(feats, (0, 0, 0, pad))
    return (feats - mean) / (2.0 * std)
